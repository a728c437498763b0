#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card. Phases, each
printing one JSON line (``"phase": ...``):

1. ``build``        — nvcc builds every kernel source of the port
                      (``src/repro_torch/kernels/csrc/*.cu``) into
                      ``build/repro_torch/``; build seconds and ptxas's
                      registers and spills per kernel.
2. ``kernels``      — K1, K2 and K6 against their plain PyTorch versions on
                      the card at N = 3,145,728 (the node18 block's state)
                      and N = 1,000,003 (a ragged tail), f32 and bf16:
                      z_next bitwise (K6's err too), K2's err and norm sum
                      within a relative tolerance; times by CUDA events
                      beside the byte bound. K6 is on no solver path: its
                      launches are this phase's own.
3. ``toy_gradient`` — paper Fig. 6, all three columns (aca, adjoint,
                      naive): dz/dt = kz through
                      ``repro_torch.benchmarks.toy_gradient`` (Dopri5
                      1e-5, ``use_pallas=True``), against the analytic
                      gradient (<= 2 x the reference's error + 1e-6) and
                      the reference's step counts; the adjoint/ACA error
                      ratio per (k, T).
4. ``node18_block`` — one node18_cifar NODE block at full width (d_model
                      768, 12 heads, d_ff 3072, x (8, 512, 768) f32),
                      NODE_TRAIN's solver on the full checkpoint buffer,
                      three SGD steps through the fused kernels; then the
                      fused path against the plain path at the same width.
5. ``kernels_batched`` — K3, K4 and K5 against their plain versions on the
                      card at (8, 393,216) and (8, 393,218) (the serving
                      state [z, t_off, delta], whose rows start unaligned),
                      f32 and bf16, HeunEuler and Dopri5 rows: z_next
                      bitwise, per-row norms within a relative tolerance,
                      h = 0 rows bitwise, K5 at K4's tolerance bitwise
                      K4; K4's and K5's partials bitwise the plain tile
                      partials (one per 2048 elements of a row), and one
                      row's partials, z_next and per-row sum the same bits
                      at B = 8, 3 and 1 and on views 0-3 elements into
                      larger buffers; times beside the byte bound, the plain
                      version and ``torch.baddbmm``, K5 also at B = 1.
6. ``serve_node18``  — ``NodeServeEngine`` over the node18 block's residual
                      branch at full width: 8 slots, HeunEuler, 16 seeded
                      requests with per-request tolerances and Poisson
                      arrivals; every request against a one-shot solo
                      solve, and one request alone against the mix, bit
                      for bit.
7. ``node18_batched`` — the node18 block with NodeConfig(batch_axis=0) on x
                      (8, 512, 768): every sample on its own grid, two SGD
                      steps; then fused against plain at the same width.
7b. ``node18_methods`` — the node18 block at full width (x (8, 512,
                      768) f32, NODE_TRAIN's HeunEuler 1e-2, full buffer):
                      one SGD step each of aca, adjoint and naive from the
                      same weights and input on K1/K2 (equal n_steps, the
                      adjoint's z(T) bitwise ACA's, the naive's within
                      NODE_RTOL, finite gradients; step, forward and
                      backward ms, peak memory, trials, the adjoint's
                      reverse steps, gradients against ACA's), each against
                      its plain path; the fixed regime (rk2) with ACA and
                      naive (gradients within 2e-4); adjoint and naive
                      under batch_axis=0 on K3/K4; K1/K2 at the adjoint's
                      augmented state (2 x 3,145,728 + the block's
                      parameters) and K3/K4 at (8, 2 x 393,216 + the
                      parameters) against their plain versions, timed.
7c. ``segmented_dense`` — slice D. (a) The node18 block at full width with
                      ``NODE_TRAIN`` as published (segmented ACA "auto": K
                      = 6, seg_len 6, K1/K2), one SGD step, and again
                      under batch_axis=0 (K3/K4), each from the same
                      weights as two steps of the full buffer: equal
                      n_steps, z(1) and every gradient within the full
                      buffer's own run-to-run gap (bitwise where it
                      repeats itself); forward, backward and step ms, peak
                      memory, the backward's extra launches. (b) ACA's
                      peak memory on the method_costs field at 65,536 x 64
                      (Dopri5 1e-5), full buffer and "auto" at max_steps
                      64 and 512, gradients bitwise. (c) K1 with Dopri5's
                      b_mid row at N = 3,145,728 and K3 with it at (8,
                      393,216) and (8, 393,218), f32 and bf16, bitwise
                      their plain versions, timed beside the byte bound;
                      ``odeint_dense`` (K1/K2) read at 1,000 times against
                      a landing solve (5e-4); the latent-ODE union-grid
                      decode and its gradient at Table 4's widths (batch
                      48, K3/K4, rtol 1e-5) against the (B, T) landing
                      solve (5e-4, fewer steps) and against its plain path
                      (2e-5, gradients 1e-5); ``dense_eval`` with the
                      reference's gates.
7d. ``solve_health_mali`` — slices E and F. (a) The node18 block at full
                      width with ``NODE_TRAIN_MALI`` as published (the ALF
                      pair stepper, MALI gradients, 1e-2, fused): one SGD
                      step solo (the backward's half-drifts on K1) and one
                      under batch_axis=0 (K3), then one of ``NODE_TRAIN``
                      ("auto") and one of the full buffer from the same
                      weights; steps, trials, evaluations, forward /
                      backward / step ms, peak memory, K1/K3 launches,
                      gradients against ACA's; the backward's
                      reconstructed start pair bitwise the encoded one,
                      finite gradients, the kernel route against the plain
                      route (steps equal, z(1) and gradients within
                      NODE_RTOL); K1 with the half-drift row (0.5,) at N =
                      3,145,728 and K3 with it at (8, 393,218), f32 and
                      bf16, bitwise their plain versions, timed beside the
                      byte bound, the plain version and ``torch.addcmul``.
                      (b) MALI's peak on the method_costs field at 65,536 x
                      64 at max_steps 64 and 512, flat within 5%, beside
                      ACA's full buffer. (c) NaN at t >= 0.5 on the fused
                      path for aca, adjoint, naive and mali, solo and at B
                      = 8 with one row faulted: NONFINITE_STATE, finite
                      outputs, zero gradients where frozen, the other rows
                      bitwise the clean batch; guard_nonfinite True
                      bitwise False on clean solves of the three engines;
                      the lattice's int32/int64 adds wrap on CUDA. (d)
                      ``failure_overhead`` in quick mode with its 5% gate.
7e. ``paper_benchmarks`` — the paper's training benchmarks on the card
                      through ``repro_torch.benchmarks``: reverse_error
                      (Fig. 4/5), method_costs (Table 1; its aca_pallas
                      row on K1/K2), classification (Table 2),
                      reliability (Table 3), solver_robustness (Tables
                      6/7), timeseries (Table 4; batch 48 x 16 per-row
                      observation times) and threebody (Table 5; 2 x 128
                      points), each in quick mode at its published widths
                      with the step and run counts of ``PAPER_CUTS``,
                      seconds per benchmark; each emits exactly the
                      reference's row names (``PAPER_ROW_NAMES``), every
                      value finite; the deterministic rows against the
                      reference's numbers on the same inputs
                      (``PAPER_REFERENCE``: van der Pol and conv-ODE
                      reverse errors within 2x either way, method_costs'
                      steps and evaluations equal, the mass fit within
                      10x and below the unfitted masses' MSE), NODE test
                      accuracy >= 0.6; aca_pallas against aca on the card
                      (z(1) bitwise, gradients 1e-5); the peak memory of
                      aca, adjoint and naive on the method_costs field at
                      65,536 x 64, where the state outnumbers the 8,192
                      parameters.
8. ``kernels_lm``   — K7 (RMSNorm), K8 (windowed GQA flash attention) and
                      K10 (RG-LRU scan) against their plain versions on the
                      card at the recurrentgemma_9b serving shapes: K7 at
                      (16384, 4096) and (16383, 4096), f32 and bf16, and
                      the decode shape (4, 4096); K8 at q (4, 16, 4096,
                      256), one kv head, window 2048 and 0, f32 and bf16,
                      and at S = 1000 (the wgmma kernel, as K8's rule
                      picks for bf16 at head dims 64-256); K8's mma.sync
                      kernel (head dims 16 and 32) at (2, 4, S, dh) with 2
                      kv heads, S 1000 and 77; K10 at (4, 4096, 4096) and (2,
                      1000, 4096), and at (4, 4096, 4096) again with weak
                      decay (log a uniform in [-1.3e-2, -1.25e-4], the
                      state carried over the whole sequence) within a
                      bound derived from f32 rounding over 4096 steps.
                      Times beside the bound (K10 at both shapes), the plain
                      version and the library call (``F.rms_norm``,
                      ``F.scaled_dot_product_attention`` with the band
                      mask; none for K10); the launch floor (an empty
                      kernel on the same ctypes route, timed as every
                      kernel is); K7 also at the decode rows (4,
                      D) of D = 4096, 2560 and 5120, through the kernel
                      its rule picks and through each of its two kernels
                      (one-pass, two-pass); K8 also at window 0 beside
                      SDPA's causal call (``is_causal=True``), and its
                      mma.sync kernel causal at (4, 16, 4096, 32). Every
                      bf16 serving call below checks that all its K8
                      launches took the wgmma kernel.
9. ``serve_recurrentgemma`` — ``ServeEngine.generate`` over
                      ``build_model(recurrentgemma_9b.CONFIG with
                      n_layers=5)``: full width (d_model 4096, 16 heads, 1
                      kv head, head_dim 256, d_ff 12288, vocab 256000,
                      window 2048, d_rnn 4096), one (rec, rec, attn) group
                      and the 2-layer rec tail, bf16 params and compute,
                      ``use_pallas=True``, seeded random weights. Call A:
                      4 prompts of 4096 tokens, 32 new (greedy; decode
                      wraps the 2048-slot ring); call B: 2 prompts of 1000,
                      16 new. Launches checked exactly per call; then the
                      plain route on the same weights (last-position
                      logits, greedy tokens where the margin allows) and
                      one f32 prefill of both routes.
10. ``kernels_ssm``  — K9 (the Mamba-2 SSD chunk scan) against its plain
                      version (``ssd_chunked``) on the card at the
                      mamba2_2_7b prefill shapes: x (4, 4096, 80, 64) and
                      (2, 1024, 80, 64), one group of state 128, chunk 256,
                      bf16 and f32, y and h_last, at the reference init and
                      (4, 4096) again with weak decay, where the state
                      carried between chunks dominates; K9's three bf16
                      kernels (chunk states, state pass, chunk outputs)
                      one at a time against their plain parts at (4, 4096),
                      both decays; K7 at the Mamba-2 widths 5120 and 2560.
                      K9's time beside its operations bound and the plain
                      version (no library call computes it), and each of
                      its three kernels' times, their sum and the design's
                      byte floor (the bytes the three move, each kernel's
                      inputs read once and outputs written once).
11. ``serve_mamba2`` — ``ServeEngine.generate`` over
                      ``build_model(mamba2_2_7b.CONFIG)``: all 64 layers at
                      full width (d_model 2560, d_inner 5120, 80 heads x 64,
                      state 128, one group, conv 4, chunk 256, vocab
                      50,280), 2.83 B parameters, bf16, ``use_pallas=True``,
                      seeded random weights. Call A: 4 prompts of 4096
                      tokens, 32 new (greedy); call B: 2 prompts of 1000
                      (padded to 1024 inside the blocks), 16 new. Launches
                      checked exactly per call (K9, and each of its three
                      kernels, once per layer per prefill, K7 2 per layer +
                      1 per prefill and per decode step); peak memory and
                      prefill time per call; one prefill of call A and one
                      decode step
                      traced with torch.profiler (device busy and idle
                      share, device time by kernel class); then the plain
                      route on the same weights and one f32 prefill of
                      both routes on call B's prompts.
11b. ``serve_moe`` — ``ServeEngine.generate`` over
                      ``build_model(deepseek_moe_16b.CONFIG)`` whole: 28
                      MoE layers (64 routed experts of 1408, 2 shared, top
                      6, capacity factor 1.25), d_model 2048, 16 heads of
                      128, vocab 102,400, 16.9 B parameters drawn leaf by
                      leaf in bf16, ``use_pallas=True``. Calls A (4 x 4096
                      + 32) and B (2 x 1000 + 16) as RecurrentGemma's:
                      launches checked exactly (K7 2 per layer + 1 per
                      prefill and per decode step, K8 once per layer per
                      prefill), prefill ms, decode ms per token, peak
                      memory; a repeated decode bitwise; the plain route on
                      the same weights (prefill logits within
                      MOE_LOGIT_BF16_RTOL, the router's choices compared
                      layer by layer: routing flips); a 4-layer f32 cut at
                      full widths, both routes within 1e-3; K8 causal at
                      (4, 16, 4096, 128) and (2, 24, 1024, 64) against its
                      plain version, timed beside SDPA's causal call and
                      the operations bound. Then ``musicgen_medium.CONFIG``
                      whole (48 layers, LayerNorm, GeLU, head dim 64,
                      1.36 B parameters, bf16) on the audio frontend's
                      embeds: a 2 x 1024-frame prefill (K8 once per layer)
                      and 16 decode frames, against the plain route.
11b2. ``serve_dense_lms`` — the six dense and MoE configs no other phase
                      serves, each at its published widths on a 4-layer
                      cut (``DENSE_LAYERS``), bf16, ``use_pallas=True``,
                      built, drawn, served and freed one at a time:
                      qwen1_5_32b (40 heads = kv heads, QKV bias),
                      qwen2_72b (64 / 8, QKV bias), command_r_35b (64 / 8)
                      and command_r_plus_104b (96 / 8; LayerNorm, the
                      parallel block, tied embeddings over a 256,000
                      vocab), llava_next_34b (56 / 8, the VLM stub's
                      embeds) and qwen3_moe_235b_a22b (64 / 4, 128
                      experts top 8, no shared expert), head dim 128.
                      Calls A (4 x 4096 + 32) and B (2 x 1000 + 16)
                      through ``ServeEngine.generate`` (llava: the same
                      loop on ``Model.prefill``/``decode_step`` with the
                      given embeds, the argmax its token): launches
                      checked exactly (K7 2 per layer + 1 per prefill and
                      per decode step, 0 for the Command-Rs' LayerNorm; K8
                      once per layer per prefill), prefill ms, decode ms
                      per token, peak memory, seconds a config; the plain
                      route on the same weights (the last prefill
                      position's logits within the config's
                      ``DENSE_LOGIT_BF16_RTOL``, qwen3-moe's routing
                      flips); a 2-layer f32 cut on call B, both routes
                      within 1e-3; K8 causal at the config's head layout
                      and call A's length against its plain version,
                      timed beside SDPA's causal call and the bound; K7
                      at the RMSNorm configs' prefill rows (16384,
                      d_model) against its plain version (one bf16 ulp),
                      timed beside ``F.rms_norm`` and the bound.
11c. ``train_node_lm`` — ``examples/train_node_lm.py --adaptive`` at full
                      width: ``node18_cifar.CONFIG`` (18 layers, d_model
                      768, vocab 32,768) in f32 with ``NODE_TRAIN`` (every
                      block an adaptive HeunEuler ODE block, ACA,
                      segmented, K1/K2), ``TokenPipeline`` (8 x 128),
                      AdamW with ``cosine_warmup``, ``TrainLoop`` with a
                      checkpoint at step 4 in a temporary directory: 6
                      steps (ms, loss, grad norm, K1/K2 launches, each
                      block's steps and trials), 0 skipped, finite loss,
                      peak memory; a fresh loop resumes at step 4 with the
                      saved params bit for bit and its steps to 6 match the
                      uninterrupted run within 1e-5; one step's loss on the
                      plain route (K1/K2's plain versions) bitwise the
                      kernel route's, gradients within 1e-5.
11d. ``serve_node_bench`` — slice H. (a) ``repro_torch.benchmarks.
                      serve_node`` in quick mode (the reference's trace:
                      24 requests, 4 slots, dim 8) with every round on
                      K3/K5: its four gates (every request OK, parity with
                      a solo solve, continuous throughput >= static,
                      static p99 / continuous p99 >= 1.5 on the sim
                      clock), its rows, host ms a round and each mode's
                      drain seconds. (b) The same trace under aca, adjoint,
                      naive and mali: the adjoint's and naive's z_final
                      and trials bitwise ACA's, every request OK; mali's
                      ``CHECKPOINT_OVERFLOW`` requests reported (its
                      64-slot grid at rtol 1e-5). (c) serve_node18's
                      trace (16 requests, 8 slots, HeunEuler, node18
                      width) served continuously and static-batched in
                      turns (continuous, static, static, continuous):
                      sim-clock p50/p99, host ms a round, drain seconds,
                      K3/K5 launches of each run.
11e. ``batched_solve`` — ``repro_torch.benchmarks.batched_solve`` at its
                      full size (32 x 64, Dopri5 1e-5, ACA): per_sample,
                      vmap_solo and lockstep forward and gradient seconds,
                      sample-evals, step spread; per_sample's per-element
                      steps vmap_solo's. It runs no kernel.
11f. ``mixed_dtype`` — slice J. The node18 block at full width on the
                      state {"x": bf16 (8, 512, 768), "e": f32 (8,)} (e
                      accumulates each sample's mean |f|^2): one SGD step
                      per method (NODE_TRAIN's settings, NODE_TRAIN_MALI's
                      for mali) after an untimed one from the same
                      weights: forward / backward ms, peak memory, steps,
                      trials, leaf dtypes kept, K1-K5 launches 0 (a mixed
                      state takes no kernel, the reference's rule). Then
                      each step at (2, 16, 768) on the card and on CPU
                      tensors from the same weights: equal counters, z(1)
                      and gradients within bounds built from the measured
                      card-to-CPU drift of one field evaluation and one
                      pullback plus one bf16 rounding a step.
11g. ``sharded_solve`` — slice I1. ``init_distributed("cuda")`` as a
                      one-rank NCCL group and ``shard_mesh()`` over it; the
                      node18 block at full width (x (8, 512, 768) f32,
                      batch_axis=0, K3/K4), one SGD step per method (aca,
                      adjoint and naive on the full buffer, mali as
                      NODE_TRAIN_MALI) with ``NodeConfig.mesh`` set,
                      against the same step without a mesh from the same
                      weights, in turns (unsharded, sharded, sharded,
                      unsharded): z(1), stats, the input's and every
                      parameter's gradient bitwise, K3/K4 launches equal,
                      2 collectives forward and 2 backward; forward /
                      backward / step ms, peak memory, the card's name and
                      power limit on every method's line.
11h. ``sharded_lm`` — slice I2. A one-rank NCCL group again and
                      ``make_debug_mesh(1, 1)`` (``("data", "model")``):
                      (a) deepseek_moe_16b whole in bf16 with use_pallas,
                      its weights wrapped as DTensors without a copy, call
                      B of serve_moe through ``ServeEngine.generate`` with
                      ``RunConfig(mesh=...)`` in turns against the same call
                      without a mesh (mesh-less, mesh, mesh, mesh-less):
                      prefill logits and the tokens bitwise, K7/K8
                      launches equal on both routes and per layer as in
                      serve_moe, the collectives of one prefill and one
                      decode step, prefill ms, decode ms a token, peak
                      memory beside serve_moe's; (b) mamba2_2_7b whole,
                      call B, the same comparison on K7/K9; (c) one AdamW
                      step of node18_cifar at full width, NODE off, f32,
                      8 x 128, against the step without a mesh: loss,
                      every gradient and the updated parameters bitwise,
                      the moments DTensors with their parameters'
                      placements (this part runs no kernel); (d) one
                      forward and backward of node18_cifar at full width
                      in NODE mode (NODE_TRAIN: K1/K2 on every block's
                      solve, each rank's batch block on the whole batch's
                      grid), 8 x 128, f32, against the mesh-less one: loss,
                      every gradient and each block's steps, trials,
                      evaluations and status bitwise, K1/K2 launches equal,
                      ms and peak GB of both. Every line carries the
                      card's name and power limit.
11i. ``remat`` — slice I5. node18_cifar at full width, 8 x 128, f32,
                      one forward and backward with ``RunConfig(remat=
                      "block")`` against ``"none"``, NODE off and
                      NODE_TRAIN on: loss, every gradient and each
                      block's stats bitwise (one entry a block), ms and
                      peak GB above the weights of both; K1/K2 launches
                      of both (the recompute's add to block's).
11j. ``cost`` — slice I3. The NODE dry run
                      (``launch/node_dryrun.py``: train with the adjoint
                      and serve with ACA, batch 64, dim 32, f32) on a
                      one-rank NCCL group through K3/K4, counted by
                      ``launch/op_cost.py``: its report, verdict (never
                      collective-bound) and measured solve beside its
                      bound; the ``whole_call_cost`` lines that serve_moe
                      and serve_mamba2 emitted (call B's prefill on a
                      one-rank "fake"-backend mesh, counted on the card
                      and dry-run on fake tensors: equal counts, logits
                      bitwise the mesh-less route's, the dry run's
                      argument + temp bytes within 10% of the allocator's
                      peak (arguments resident) less what earlier phases
                      held, and its temp bytes
                      within 10% of the peak above them, the roofline
                      terms and the share bound / measured beside the card's
                      name and power limit); one ``--remat block`` train
                      step of node18_cifar at full width (8 x 128, AdamW,
                      clipping) on a one-rank "fake"-backend mesh, counted
                      on the card and dry-run (``build_cell``): FLOPs by
                      dtype equal; ``python -m
                      repro_torch.launch.dryrun --arch deepseek_moe_16b
                      --shape decode_32k`` in a subprocess (one ``[ok]``).
11k. ``analysis`` — slice I4. The analyzer's 37 configurations
                      (``repro_torch.analysis``: dim 96, batch 8, two eval
                      times, 64 steps, zero inputs) run on the card
                      through ``odeint``, forward and backward under its
                      ``Recorder``, the ``-pallas`` ones on K1/K2 and
                      K3/K4/K5, with no finding of its four passes; each
                      against a CPU run of the same config in the same
                      process (one default group, gloo for CPU tensors and
                      one NCCL rank for the card's): host reads per loop
                      and outside loops, collectives and residual bytes
                      equal, K1-K5 launches equal to the run's kernel
                      entries. K1/K2 at the solo configs' (96,) and
                      K3/K4/K5 at the batched ones' (8, 96) and the
                      serving row's (8, 98), f32, on random inputs against
                      their plain versions (z_next bitwise, norms and K2's
                      err within their relative tolerances); each
                      ``-pallas`` config on seeded nonzero z0 and w through
                      the kernels and through the plain route on the card
                      (steps, trials and status equal, every status OK,
                      ys bitwise, dL/dz0 and dL/dw within 1e-5); then
                      ``repro_torch.examples.quickstart`` on the card and
                      the CPU, each method's relative error against the
                      analytic gradient at most 10x the CPU's.
12. the ``kernels`` summary line (K1-K10, and K9's three kernels; each
   with the launch floor, K1 and K3 with their half-drift times, K7 with
   its decode times, its times at serve_dense_lms's prefill rows and the
   launches of
   each of its two kernels over the LM paths, K8 with its window-0 time
   and SDPA's causal time and its causal times at head dims 128 and 64
   and at the six serve_dense_lms head layouts, K10 with its time at call
   B's shape, K3 and
   K5 with their times at the batched block's aligned rows, K5 also on
   one serving row, K4 at the serving row), the card's name and power
   limit,
   and the last line ``{"ok": true, "device": {...}}``.

Each main path (node18_block for K1/K2, serve_node18 for K3/K5,
node18_batched for K3/K4, node18_methods' solo steps and fixed-regime
steps for K1/K2 and its batched steps for K3/K4, segmented_dense's
NODE_TRAIN steps, dense solve and latent decode for K1-K4,
solve_health_mali's NODE_TRAIN_MALI steps for K1/K3,
paper_benchmarks' runs for K1/K2, each
serve_recurrentgemma call for K7/K8/K10, each serve_mamba2 call for
K7/K9, each serve_moe call and the musicgen prefill and decode for K7/K8,
each serve_dense_lms call for K7/K8,
train_node_lm's six steps for K1/K2, serve_node_bench's quick benchmark
and each of its node18 serving runs for K3/K5, mixed_dtype's steps for
none of K1-K5, each method's sharded steps for K3/K4, sharded_lm's first
mesh call of each model for K7/K8 and K7/K9, sharded_lm's NODE step on
each route for K1/K2, each of remat's counted steps for K1/K2, each
whole call's counted mesh prefill for K7/K8 and K7/K9, each NODE dry run
for K3/K4, each card run of the analysis phase for K1-K5) runs with
every launch count set to 0 just before it and read just after.

Any failure raises and the script exits non-zero without the last line.
Without a card, or without the port's sources beside it, it exits 2.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

NODE18_SHAPE = (8, 512, 768)
RAGGED_N = 1_000_003
# per-sample rows of the batched paths: one (512, 768) sample, and the
# serving state [z, t_off, delta] two values wider
BATCH_ROWS = NODE18_SHAPE[0]
ROW_N = NODE18_SHAPE[1] * NODE18_SHAPE[2]
SERVE_ROW_N = ROW_N + 2
SERVE_REQUESTS = 16

RG_LAYERS = 5                   # one (rec, rec, attn) group + 2 rec tail
RG_CALLS = {"A": (4, 4096, 32), "B": (2, 1000, 16)}  # prompts, length, new
LM_KERNELS = ("rmsnorm", "flash_attention", "rg_lru")

# paper Fig. 6, ACA column: the reference's fused path on the CPU
# (rel err, n_steps, n_trials, nfe) at dopri5, rtol=atol=1e-5
TOY_REFERENCE = {
    (-2.0, 0.5): (5.7e-6, 4, 4, 27), (-2.0, 1.0): (1.8e-5, 6, 6, 39),
    (-2.0, 2.0): (9.3e-5, 10, 10, 63), (-2.0, 3.0): (5.2e-4, 13, 13, 81),
    (-2.0, 4.0): (2.8e-3, 15, 15, 93),
    (2.0, 0.5): (2.2e-6, 4, 4, 27), (2.0, 1.0): (4.7e-6, 6, 6, 39),
    (2.0, 2.0): (1.1e-5, 11, 11, 69), (2.0, 3.0): (1.6e-5, 16, 16, 99),
    (2.0, 4.0): (2.3e-5, 21, 21, 129),
}

# paper Fig. 6, the adjoint and naive columns: the reference on the CPU,
# (rel err, n_steps) from benchmarks/bench_toy_gradient.grad_rel_error and
# its forward solve (tests/torch_toy_reference.py prints this table)
TOY_REFERENCE_METHODS = {
    ('adjoint', -2.0, 0.5): (5.24e-06, 4),
    ('adjoint', -2.0, 1.0): (3.71e-05, 6),
    ('adjoint', -2.0, 2.0): (4.32e-04, 10),
    ('adjoint', -2.0, 3.0): (4.37e-03, 13),
    ('adjoint', -2.0, 4.0): (5.18e-02, 15),
    ('adjoint', 2.0, 0.5): (1.26e-06, 4),
    ('adjoint', 2.0, 1.0): (2.69e-06, 6),
    ('adjoint', 2.0, 2.0): (7.65e-06, 11),
    ('adjoint', 2.0, 3.0): (1.16e-05, 16),
    ('adjoint', 2.0, 4.0): (1.77e-05, 21),
    ('naive', -2.0, 0.5): (4.13e-06, 4),
    ('naive', -2.0, 1.0): (1.49e-05, 6),
    ('naive', -2.0, 2.0): (5.54e-05, 10),
    ('naive', -2.0, 3.0): (8.93e-05, 13),
    ('naive', -2.0, 4.0): (6.66e-04, 15),
    ('naive', 2.0, 0.5): (1.86e-06, 4),
    ('naive', 2.0, 1.0): (4.00e-06, 6),
    ('naive', 2.0, 2.0): (1.01e-05, 11),
    ('naive', 2.0, 3.0): (1.53e-05, 16),
    ('naive', 2.0, 4.0): (2.18e-05, 21),
}
# ACA against naive on one fixed grid, as max |dg| / max |g| per
# parameter: tests/test_odeint_grad.py's
# test_aca_equals_naive_discretize_then_optimize rtol
FIXED_ACA_NAIVE_RTOL = 2e-4

# K2's err is the plain version's arithmetic in the same order (expected
# bitwise); its norm is summed per block then over blocks, the plain
# version's by one torch.sum: f32 summation order over N terms
ERR_RTOL = 1e-6
NORM_RTOL = 1e-5
# fused vs plain solve of the node18 block: the fused norm's summation
# order moves the error ratio, hence h, by ulps; z(1) and the ACA
# gradients follow by the same order
NODE_RTOL = 1e-4
# per-row norms of K4/K5 (block partials summed per row) against the plain
# version's one torch.sum per row over N terms
ROW_NORM_RTOL = 1e-6
# K7 against torch's RMSNorm, as max |diff| / max |plain|: f32 sums the
# squares in another order and rsqrtf differs by an ulp or two; bf16 both
# round one f32 value, so one bf16 ulp of each value
RMS_F32_RTOL = 2e-6
RMS_BF16_ULPS = 1.0
# K8 against dense masked attention in f32: FMA sums in another order
# (f32); the kernel rounds p to bf16 for the tensor cores (bf16)
ATT_F32_RTOL = 2e-5
ATT_BF16_RTOL = 1e-2
# and in bf16 per tile of 16 rows (a warp's rows in both bf16 kernels),
# max over tiles of ||out - plain|| / ||plain||: the max above sits on the
# first rows, which see few keys and reach ~3, so a fault confined to the
# long rows (values ~0.03) hides under it. The bf16 roundings of p and of
# both outputs put a sound kernel at 2.8e-3 a tile at the main-path shapes
# on an H100, and up to 5e-3 at head dim 16 in a CPU emulation of those
# roundings; a single row's norm would swing more there.
# tests/torch_k7_k8_ablations.py plants faults that this gate sees and
# the one above does not
ATT_BF16_ROWS_RTOL = 1e-2
# K10 against the doubling scan: products in another order
LRU_RTOL = 1e-5
# K10 with weak decay, Griffin's trained range a^8 in [0.9, 0.999] at r = 1
# (src/repro/models/rglru.py:53), so the state carries over the whole
# sequence: an error made at a step reaches later steps scaled by decay
# factors <= 1, so over S steps the kernel's roundings (under 3 a step:
# the state's multiply-add, the segment product, the compose once a
# segment) and expf's 2 ulp (should torch.exp differ) add at most
# 5 S 2^-24 of max |h| (1.2e-3 at S = 4096)
LRU_WEAK_LOG_A = (-1.3e-2, -1.25e-4)


def lru_weak_rtol(s: int) -> float:
    return 5 * s * 2.0 ** -24


# the served model, kernels vs plain route, as a share of max |logit|:
# bf16 activations round at every layer in other places (K8 keeps scores
# in f32 where the plain route rounds them to bf16), so the routes agree
# to a few bf16 ulps of the logits; in f32 only summation order differs.
# Two logits each within the tolerance can swap places only where their
# margin is under twice it: greedy tokens must agree wherever the plain
# route's top-2 margin exceeds 2 x LOGIT_BF16_RTOL x max |logit|
LOGIT_BF16_RTOL = 2e-2
LOGIT_F32_RTOL = 1e-3

# K9 against its plain version (ssd_chunked), as a share of max |plain|:
# f32 sums its products and the chunk cumsum in other orders; in bf16 both
# round one near-f32 value to bf16, so one bf16 ulp of each plain value on
# top of the f32 bound. h_last is f32 in both.
SSD_F32_RTOL = 1e-4
# the weak-decay K9 case is drawn so that a chunk keeps about e^-1 of its
# state; below this median the carried state would no longer dominate
SSD_WEAK_DECAY = 0.1
M2_CALLS = {"A": (4, 4096, 32), "B": (2, 1000, 16)}  # prompts, length, new
# K9's three bf16 kernels, each launched once per bf16 K9 call
K9_PARTS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")
SSM_KERNELS = ("rmsnorm", "ssd_scan") + K9_PARTS
# the served Mamba-2, kernels vs plain route, as a share of max |logit|,
# derived before the first run: per layer the routes round the mixer's
# output differently by about one bf16 ulp (2^-8; K9 rounds y to bf16
# before the D-skip, the plain route after it; K7 and torch's RMSNorm may
# round a value to neighbouring bf16 numbers), independently from layer to
# layer, so over 64 layers the residual stream drifts by about sqrt(64) x
# 2^-8 = 3.1e-2 of its size; with a factor 1.6 for the head, 5e-2. Greedy
# tokens must agree wherever the plain route's top-2 margin exceeds
# 2 x M2_LOGIT_BF16_RTOL x max |logit|; the f32 prefill as LOGIT_F32_RTOL.
M2_LOGIT_BF16_RTOL = 5e-2

# the paper_benchmarks phase: each benchmark's quick mode at its
# published widths, with these cuts of step and run counts (seconds per
# benchmark on the card in the phase's line)
PAPER_CUTS = {
    "reverse_error": {},
    "method_costs": {},
    "classification": {"steps": 30},
    "reliability": {"n_runs": 2, "steps": 30},
    "solver_robustness": {"steps": 30},
    "timeseries": {"batch": 48, "steps": 6},
    "threebody": {"n_pts": 128, "fit_steps": 3},
}
# the reference's quick-mode rows, written down by
# tests/torch_bench_reference.py
PAPER_ROW_NAMES = {
    'reverse_error': (
        'fig4_vdp_reverse_relerr/mu=0.15',
        'fig4_vdp_reverse_relerr/mu=4.0',
        'fig5_conv_reverse_relerr/T=1.0',
    ),
    'method_costs': (
        'table1_accepted_steps/aca',
        'table1_accepted_steps/aca_pallas',
        'table1_accepted_steps/adjoint',
        'table1_accepted_steps/naive',
        'table1_grad_walltime_ms/aca',
        'table1_grad_walltime_ms/aca_pallas',
        'table1_grad_walltime_ms/adjoint',
        'table1_grad_walltime_ms/naive',
        'table1_nfe/aca',
        'table1_nfe/aca_pallas',
        'table1_nfe/adjoint',
        'table1_nfe/naive',
        'table1_residual_bytes/aca',
        'table1_residual_bytes/aca_pallas',
        'table1_residual_bytes/adjoint',
        'table1_residual_bytes/naive',
    ),
    'classification': (
        'table2_test_acc/discrete',
        'table2_test_acc/node_aca',
        'table2_test_acc/node_adjoint',
        'table2_test_acc/node_naive',
    ),
    'reliability': (
        'table3_icc1/discrete',
        'table3_icc1/node',
        'table3_pairwise_agreement/discrete',
        'table3_pairwise_agreement/node',
    ),
    'solver_robustness': (
        'table6_discrete_base_acc',
        'table6_discrete_delta/euler_steps2',
        'table6_discrete_delta/euler_steps8',
        'table6_discrete_delta/rk2_steps4',
        'table6_discrete_delta/rk4_steps2',
        'table7_node_base_acc/heun_euler',
        'table7_node_delta/bosh3',
        'table7_node_delta/dopri5',
        'table7_node_delta/euler_steps2',
        'table7_node_delta/euler_steps8',
        'table7_node_delta/rk2_steps4',
        'table7_node_delta/rk4_steps2',
    ),
    'timeseries': (
        'table4_latentode_mse/aca',
        'table4_latentode_mse/adjoint',
        'table4_latentode_mse/naive',
        'table4_rnn_baseline_mse',
    ),
    'threebody': (
        'table5_lstm_mse',
        'table5_node_mse/aca',
        'table5_ode_mse/aca',
        'table5_ode_mse/adjoint',
        'table5_ode_mse/naive',
    ),
}
# the reference's deterministic rows on the port's inputs at PAPER_CUTS
# (tests/torch_bench_reference.py)
PAPER_REFERENCE = {
    'reverse_error': {
        'fig4_vdp_reverse_relerr/mu=0.15': 1.414801e-05,
        'fig4_vdp_reverse_relerr/mu=4.0': 8.896619e+07,
        'fig5_conv_reverse_relerr/T=1.0': 1.021252e-05,
    },
    'method_costs': {
        'aca': {'n_steps': 12, 'n_trials': 12, 'nfe': 75},
        'adjoint': {'n_steps': 12, 'n_trials': 12, 'nfe': 75},
        'naive': {'n_steps': 12, 'n_trials': 256, 'nfe': 1792},
        'aca_pallas': {'n_steps': 12, 'n_trials': 12, 'nfe': 75},
    },
    'threebody': {
        'table5_ode_mse/unfitted': 1.854946e-03,
        'table5_ode_mse/aca': 2.872016e-04,
        'masses/aca': [0.9341726303100586, 0.8649470806121826, 1.1548421382904053],
        'table5_ode_mse/adjoint': 4.450661e-04,
        'masses/adjoint': [0.9152268767356873, 0.8690213561058044, 1.1440869569778442],
        'table5_ode_mse/naive': 1.244657e-03,
        'masses/naive': [1.1020901203155518, 0.9718751907348633, 1.148445963859558],
    },
}
# Fig. 4/5 against the reference: the drift is a difference of nearly
# equal trajectories, so each device's rounding moves it (the port 7% from
# the reference on the CPU at mu = 0.15); within a factor 2 either way
REVERSE_FACTOR = 2.0
REVERSE_FLOOR = 1e-6
# Table 5's mass fit after PAPER_CUTS' 3 AdamW steps from log m = 0: on
# the CPU, through the bodies' close approach (t = 0.75-1 yr) the
# reference's and the port's Dopri5 1e-5 trajectories part by 4.6e-5 and
# their mass gradients by about 20%, a component flipping its sign (the
# adjoint's m1, the naive's near-zero m2; tests/torch_mass_fit_trace.py
# --reference). Adam moves each log-mass by about +-lr by that sign, so
# the MSE after 3 steps is settled component by component by noise: the
# reference's three (below) and the port's on the card (3.0e-4, 1.5e-4,
# 3.3e-4) span 1.5e-4..1.24e-3. Held within 10x of the reference's either
# way, and below the unfitted masses' MSE (the fit moved toward the
# truth)
MASS_FIT_FACTOR = 10.0
MASS_FIT_FLOOR = 0.0
# Table 2: NODE test accuracy after PAPER_CUTS' 30 steps (chance 1/3; the
# port on the CPU at these cuts: 0.803-0.807)
NODE_MIN_ACC = 0.6
# method_costs' aca_pallas against aca on the card: the replay's gradients
# through K1's plain version (z(1) bitwise)
PALLAS_GRAD_RTOL = 1e-5
# peak memory of each method where the state (65,536 x 64) outnumbers the
# 8,192 parameters of the method_costs field
MEMORY_ROWS = 65_536

K1_K2 = ("rk_stage_increment", "rk_stage_combine_err")
SERVE_KERNELS = ("rk_stage_increment_batched",
                 "rk_stage_combine_err_batched_rowtol")
BATCHED_KERNELS = ("rk_stage_increment_batched",
                   "rk_stage_combine_err_batched")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


# ------------------------------------------------------------------ timing

def time_ms(torch, fn, iters: int = 30, warmup: int = 5, prep=None) -> float:
    """Mean device time of ``fn`` by CUDA events around each launch.

    Before each launch the card first spins ~1 ms (so the host has
    enqueued all of ``fn`` before the start event runs: host overhead is
    not timed) and then writes 128 MB (so ``fn`` finds the 50 MB L2 cold,
    as a solve's field evaluation leaves it between two stage kernels).
    ``prep`` (for a kernel that works in place) runs before each launch,
    outside the timed span.
    """
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        if prep is not None:
            prep()
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        if prep is not None:
            prep()
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


# ------------------------------------------------------------------ phases

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    infos = build.build_all()
    seconds = time.perf_counter() - t0
    kernels = []
    for info in infos:
        current = None
        for line in info.log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = {"source": info.name, "entry": m.group(1)}
                kernels.append(current)
            m = re.search(r"Used (\d+) registers", line)
            if m and current is not None:
                current["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and current is not None:
                current["spill_stores"] = int(m.group(1))
                current["spill_loads"] = int(m.group(2))
    emit({"phase": "build", "ok": True, "seconds": seconds,
          "sources": [i.name for i in infos],
          "built_now": [i.name for i in infos if i.built],
          "kernels": kernels})


def phase_kernels(torch, seed: int):
    from repro_torch.core.tableaus import DOPRI5, HEUN_EULER
    from repro_torch.kernels import rk_stage
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = {"rk_stage_increment": 0.0, "rk_stage_combine_err": 0.0,
             "rk_stage_combine": 0.0}
    cases = []
    n_main = math.prod(NODE18_SHAPE)
    for n in (n_main, RAGGED_N):
        for dtype in (torch.float32, torch.bfloat16):
            z = torch.randn(n, generator=gen, device="cuda").to(dtype)
            k = torch.randn(7, n, generator=gen, device="cuda").to(dtype)
            h = torch.full((), 0.0375, device="cuda")
            rows = [("heun_euler", i, HEUN_EULER.a[i])
                    for i in range(1, HEUN_EULER.stages)]
            rows.append(("heun_euler", HEUN_EULER.stages, HEUN_EULER.b))
            rows += [("dopri5", i, DOPRI5.a[i])
                     for i in range(1, DOPRI5.stages)]
            rows.append(("dopri5", DOPRI5.stages, DOPRI5.b))
            for tab, i, a in rows:
                kk = k[:i].contiguous()
                out = rk_stage.rk_stage_increment(z, kk, h, a)
                ref = rk_stage.increment_plain(z, kk, h, a)
                torch.cuda.synchronize()
                diff = float((out.float() - ref.float()).abs().max())
                worst["rk_stage_increment"] = max(
                    worst["rk_stage_increment"], diff)
                check(torch.equal(out, ref),
                      f"K1 {tab} row {i} n={n} {dtype}: not bitwise equal "
                      f"to the plain version (max |diff| {diff})")
            for tab in (HEUN_EULER, DOPRI5):
                kk = k[:tab.stages].contiguous()
                for with_err in (True, False):
                    zn, err, part = rk_stage.rk_stage_combine_err(
                        z, kk, h, tab.b, tab.b_err, 1e-2, 1e-2,
                        with_err=with_err)
                    zn_p, err_p, sq_p = rk_stage.combine_err_plain(
                        z, kk, h, tab.b, tab.b_err, 1e-2, 1e-2, with_err)
                    torch.cuda.synchronize()
                    diff = float((zn.float() - zn_p.float()).abs().max())
                    check(torch.equal(zn, zn_p),
                          f"K2 {tab.name} n={n} {dtype} with_err={with_err}:"
                          f" z_next not bitwise equal (max |diff| {diff})")
                    sq, sqp = float(part.sum()), float(sq_p.sum())
                    check(abs(sq - sqp) <= NORM_RTOL * abs(sqp),
                          f"K2 {tab.name} n={n} {dtype}: norm {sq} vs {sqp}")
                    if with_err:
                        ed = float((err - err_p).abs().max())
                        check(ed <= ERR_RTOL * float(err_p.abs().max()),
                              f"K2 {tab.name} n={n} {dtype}: err |diff| {ed}")
                        diff = max(diff, ed)
                    worst["rk_stage_combine_err"] = max(
                        worst["rk_stage_combine_err"], diff)
            for tab in (HEUN_EULER, DOPRI5):
                kk = k[:tab.stages].contiguous()
                for e in (tab.b_err, None):
                    zn, err = rk_stage.rk_stage_combine(z, kk, h, tab.b, e)
                    zn_p, err_p = rk_stage.combine_plain(z, kk, h, tab.b, e)
                    torch.cuda.synchronize()
                    diff = max(float((zn.float() - zn_p.float()).abs().max()),
                               float((err - err_p).abs().max()))
                    worst["rk_stage_combine"] = max(
                        worst["rk_stage_combine"], diff)
                    check(torch.equal(zn, zn_p) and torch.equal(err, err_p),
                          f"K6 {tab.name} n={n} {dtype} e={e is not None}: "
                          f"not bitwise equal (max |diff| {diff})")
            cases.append({"n": n, "dtype": str(dtype).replace("torch.", ""),
                          "k1_rows": len(rows), "bitwise": True})
    # K6 is on no solver path: its launches are this phase's own
    k6_launches = rk_stage.launches["rk_stage_combine"]
    emit({"phase": "kernels", "ok": True, "cases": cases,
          "max_abs_err": worst, "err_rtol": ERR_RTOL,
          "norm_rtol": NORM_RTOL, "k6_launches": k6_launches})

    # times at the main path's shape and type: node18's f32 state
    n = n_main
    z = torch.randn(n, generator=gen, device="cuda")
    k = torch.randn(7, n, generator=gen, device="cuda")
    h = torch.full((), 0.0375, device="cuda")
    timings = {}

    def k1_entry(label, a, rows_k):
        kk = k[:rows_k].contiguous()
        work = rk_stage.increment_work(1, n, rk_stage.used_stages(
            a[:rows_k]))
        hw = h * torch.tensor(a[:rows_k], dtype=torch.float32, device="cuda")
        kt = kk.t()
        timings[label] = {
            "ms": time_ms(torch, lambda: rk_stage.rk_stage_increment(
                z, kk, h, a)),
            "plain_ms": time_ms(torch, lambda: rk_stage.increment_plain(
                z, kk, h, a)),
            "library_ms": time_ms(torch, lambda: torch.addmv(z, kt, hw)),
        }
        _bound(timings[label], work)

    def k2_entry(label, tab, with_err):
        kk = k[:tab.stages].contiguous()
        work = rk_stage.combine_err_work(n, rk_stage.used_stages(
            tab.b, tab.b_err), with_err=with_err)
        timings[label] = {
            "ms": time_ms(torch, lambda: rk_stage.rk_stage_combine_err(
                z, kk, h, tab.b, tab.b_err, 1e-2, 1e-2,
                with_err=with_err)),
            "plain_ms": time_ms(torch, lambda: rk_stage.combine_err_plain(
                z, kk, h, tab.b, tab.b_err, 1e-2, 1e-2, with_err)),
            "library_ms": None,
        }
        _bound(timings[label], work)

    def k6_entry(label, tab):
        kk = k[:tab.stages].contiguous()
        work = rk_stage.combine_work(n, rk_stage.used_stages(tab.b,
                                                             tab.b_err))
        timings[label] = {
            "ms": time_ms(torch, lambda: rk_stage.rk_stage_combine(
                z, kk, h, tab.b, tab.b_err)),
            "plain_ms": time_ms(torch, lambda: rk_stage.combine_plain(
                z, kk, h, tab.b, tab.b_err)),
            "library_ms": None,
        }
        _bound(timings[label], work)

    k1_entry("k1_heun_stage", HEUN_EULER.a[1], 1)      # trial loop
    k1_entry("k1_heun_b", HEUN_EULER.b, 2)             # ACA replay
    k1_entry("k1_dopri5_b", DOPRI5.b, 7)
    k2_entry("k2_heun", HEUN_EULER, False)             # trial loop
    k2_entry("k2_dopri5", DOPRI5, False)
    k6_entry("k6_heun", HEUN_EULER)
    for t in timings.values():
        t["achieved_GBps"] = t["bytes"] / (t["ms"] * 1e-3) / 1e9
    emit({"phase": "kernel_times", "ok": True, "n": n, "dtype": "float32",
          "timings": timings})
    return worst, timings, k6_launches


def phase_toy_gradient(torch):
    from repro_torch.benchmarks.toy_gradient import toy_case
    from repro_torch.kernels import ops, rk_stage
    rows = []
    ops.reset_launches()
    for (k, t_end), (ref_err, ref_steps, ref_trials, ref_nfe) in \
            TOY_REFERENCE.items():
        errs = {}
        for method in ("aca", "adjoint", "naive"):
            err, st = toy_case(method, k, t_end, device="cuda",
                               use_pallas=True)
            if method != "aca":
                ref_err, ref_steps = TOY_REFERENCE_METHODS[
                    (method, k, t_end)]
            row = {"method": method, "k": k, "T": t_end, "rel_err": err,
                   "ref_rel_err": ref_err, "n_steps": int(st.n_steps),
                   "n_trials": int(st.n_trials), "nfe": int(st.nfe)}
            rows.append(row)
            errs[method] = err
            got = (row["n_steps"], row["n_trials"], row["nfe"])
            if method == "aca":
                check(got == (ref_steps, ref_trials, ref_nfe),
                      f"toy aca k={k} T={t_end}: (n_steps, n_trials, nfe) "
                      f"{got} != reference {(ref_steps, ref_trials, ref_nfe)}")
            else:
                check(row["n_steps"] == ref_steps,
                      f"toy {method} k={k} T={t_end}: n_steps "
                      f"{row['n_steps']} != reference {ref_steps}")
            check(err <= 2 * ref_err + 1e-6,
                  f"toy {method} k={k} T={t_end}: rel err {err} > 2 x "
                  f"{ref_err} + 1e-6")
        emit({"phase": "toy_gradient_ratio", "k": k, "T": t_end,
              "adjoint_over_aca": errs["adjoint"] / max(errs["aca"], 1e-12),
              "rel_err": errs})
    launches = {k: rk_stage.launches[k] for k in K1_K2}
    check(all(v > 0 for v in launches.values()),
          f"toy solves did not launch K1 and K2: {launches}")
    emit({"phase": "toy_gradient", "ok": True, "cases": rows,
          "launches": launches})


def _node18_train(torch, seed: int, ncfg, n_train: int, kernels,
                  phase: str):
    """The node18 block at full width under ``ncfg``: ``n_train`` SGD
    steps (the main path, launch counts set to 0 before it and read after
    it; ``kernels`` must each launch), then the fused path against the
    plain path at the same width. Returns (launches, step rows)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import node18_cifar
    from repro_torch.kernels import ops, rk_stage
    from repro_torch.models.config import RunConfig
    from repro_torch.models.transformer import TransformerBlock, node_block

    rcfg = RunConfig(compute_dtype=torch.float32, node=ncfg)
    block = TransformerBlock(node18_cifar.CONFIG, rcfg, seed=seed,
                             device="cuda")
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        NODE18_SHAPE).astype(np.float32)).cuda()
    opt = torch.optim.SGD(block.parameters(), lr=1e-2)
    steps = []
    torch.cuda.synchronize()
    ops.reset_launches()                   # the main path starts here
    for step in range(n_train):
        before = dict(rk_stage.launches)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        zT, st = node_block(block, x, ncfg)
        loss = torch.mean(zT ** 2)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        grads_finite = all(bool(torch.isfinite(p.grad).all())
                           for p in block.parameters())
        # per-row lists under batch_axis, numbers for the solo solve
        row = {"step": step, "loss": float(loss.detach()),
               "n_steps": st.n_steps.tolist(),
               "n_trials": st.n_trials.tolist(), "nfe": st.nfe.tolist(),
               "status": st.status.tolist(),
               "launches": {k: rk_stage.launches[k] - before[k]
                            for k in kernels},
               "step_ms": 1e3 * step_s,
               "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9}
        steps.append(row)
        emit({"phase": f"{phase}_step", **row})
        check(math.isfinite(row["loss"]) and grads_finite,
              f"{phase} step {step}: non-finite loss or gradients")
        check(not any(st.status.reshape(-1).tolist()),
              f"{phase} step {step}: status {row['status']}")
    launches = dict(rk_stage.launches)     # the main path ends here
    check(all(launches[k] > 0 for k in kernels),
          f"the {phase} steps did not launch {kernels}: {launches}")

    # fused (kernels) against plain (tensor ops) at the same width
    results = {}
    for up in (True, False):
        cfg = dataclasses.replace(ncfg, use_pallas=up)
        for p in block.parameters():
            p.grad = None
        xg = x.clone().requires_grad_()
        zT, st = node_block(block, xg, cfg)
        torch.mean(zT ** 2).backward()
        results[up] = (zT.detach(), st.n_steps.tolist(), xg.grad,
                       {n: p.grad.clone() for n, p in
                        block.named_parameters()})
    (z1, s1, gx1, gp1), (z0, s0, gx0, gp0) = results[True], results[False]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    rels = {"z1": rel(z1, z0), "x": rel(gx1, gx0)}
    rels.update({n: rel(gp1[n], gp0[n]) for n in gp0})
    finite = all(bool(torch.isfinite(t).all())
                 for t in [z1, z0, gx1, gx0, *gp1.values(), *gp0.values()])
    emit({"phase": phase, "ok": True,
          "shape": list(NODE18_SHAPE), "d_model": node18_cifar.CONFIG.d_model,
          "n_heads": node18_cifar.CONFIG.n_heads,
          "d_ff": node18_cifar.CONFIG.d_ff, "batch_axis": ncfg.batch_axis,
          "solver": ncfg.solver, "rtol": ncfg.rtol, "atol": ncfg.atol,
          "launches": {k: launches[k] for k in launches if launches[k]},
          "fused_vs_plain": {"n_steps": [s1, s0], "max_rel": rels,
                             "rtol": NODE_RTOL, "finite": finite}})
    check(s1 == s0, f"{phase} fused vs plain n_steps {s1} != {s0}")
    check(finite, f"{phase} fused vs plain: non-finite values")
    bad = {k: v for k, v in rels.items() if not v <= NODE_RTOL}
    check(not bad, f"{phase} fused vs plain beyond {NODE_RTOL}: {bad}")
    return launches, steps


def phase_node18(torch, seed: int):
    from repro_torch.configs import node18_cifar
    from repro_torch.models.transformer import full_buffer
    return _node18_train(torch, seed, full_buffer(node18_cifar.NODE_TRAIN),
                         3, K1_K2, "node18_block")


def phase_kernels_batched(torch, seed: int):
    from repro_torch.core.tableaus import DOPRI5, HEUN_EULER
    from repro_torch.kernels import ops, rk_stage
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    worst = {"rk_stage_increment_batched": 0.0,
             "rk_stage_combine_err_batched": 0.0,
             "rk_stage_combine_err_batched_rowtol": 0.0}
    B, frozen = BATCH_ROWS, 3
    rt = torch.logspace(-2, -4, B, device="cuda")
    at = 0.1 * rt
    cases = []

    def norms_close(part, sq_plain, what):
        sq = part.sum(dim=-1)
        bad = (sq - sq_plain).abs() > ROW_NORM_RTOL * sq_plain.abs()
        check(not bool(bad.any()),
              f"{what}: per-row norms {sq.tolist()} vs plain "
              f"{sq_plain.tolist()}")

    def k4_k5(tab, z, k, sel):
        """K4's and K5's (z_next, partials), then the per-row sums the
        solver reads (``ops``: partials.sum(-1))."""
        args = (z, k, h[sel], tab.b, tab.b_err)
        return (*rk_stage.rk_stage_combine_err_batched(*args, 1e-2, 1e-2),
                *rk_stage.rk_stage_combine_err_batched_rowtol(
                    *args, rt[sel], at[sel]),
                ops.rk_stage_combine_err_batched(*args, 1e-2, 1e-2)[1],
                ops.rk_stage_combine_err_batched(*args, rt[sel],
                                                 at[sel])[1])

    def tile_checks(tab, z, kk, tag):
        """K4's and K5's partials bitwise the plain tile partials; row 5's
        partials, z_next and per-row sums the same bits at B = 8, 3 and 1
        and on views 0-3 elements into larger buffers. Returns the paths
        taken (vector or not)."""
        n = z.shape[1]
        got = k4_k5(tab, z, kk, slice(None))
        for part, tols in ((got[1], (1e-2, 1e-2)), (got[3], (rt, at))):
            want = rk_stage.combine_err_batched_tile_partials(
                z, kk, h, tab.b, tab.b_err, *tols, rk_stage.NORM_TILE)
            check(tuple(part.shape) == (B, rk_stage.norm_tiles(n))
                  and torch.equal(part, want),
                  f"K4/K5 {tab.name} {tag}: partials {tuple(part.shape)} "
                  "not bitwise the plain tile partials")
        row = 5
        want = [x[row] for x in got]
        paths = set()
        for lo, hi in ((0, B), (4, 7), (5, 6)):
            b = hi - lo
            for shift in range(4):
                zv = torch.empty(b * n + shift, dtype=z.dtype,
                                 device="cuda")[shift:].view(b, n)
                kv = torch.empty(kk.shape[0] * b * n + shift, dtype=z.dtype,
                                 device="cuda")[shift:].view(
                                     kk.shape[0], b, n)
                zv.copy_(z[lo:hi])
                kv.copy_(kk[:, lo:hi])
                paths.add(rk_stage.row_vectorized(b, n, z.dtype, zv, kv))
                got = k4_k5(tab, zv, kv, slice(lo, hi))
                check(all(torch.equal(g[row - lo], w)
                          for g, w in zip(got, want)),
                      f"K4/K5 {tab.name} {tag}: row {row} at B = {b}, "
                      f"{shift} elements in, not the bits of B = {B}")
        return sorted(paths)

    for n in (ROW_N, SERVE_ROW_N):
        for dtype in (torch.float32, torch.bfloat16):
            z = torch.randn(B, n, generator=gen, device="cuda").to(dtype)
            k = torch.randn(7, B, n, generator=gen, device="cuda").to(dtype)
            h = torch.linspace(0.01, 0.08, B, device="cuda")
            h[frozen] = 0.0                      # a frozen row
            rows = [("heun_euler", i, HEUN_EULER.a[i])
                    for i in range(1, HEUN_EULER.stages)]
            rows.append(("heun_euler", HEUN_EULER.stages, HEUN_EULER.b))
            rows += [("dopri5", i, DOPRI5.a[i])
                     for i in range(1, DOPRI5.stages)]
            rows.append(("dopri5", DOPRI5.stages, DOPRI5.b))
            tag = f"n={n} {dtype}"
            for tab, i, a in rows:
                kk = k[:i].contiguous()
                out = rk_stage.rk_stage_increment_batched(z, kk, h, a)
                ref = rk_stage.increment_batched_plain(z, kk, h, a)
                torch.cuda.synchronize()
                diff = float((out.float() - ref.float()).abs().max())
                worst["rk_stage_increment_batched"] = max(
                    worst["rk_stage_increment_batched"], diff)
                check(torch.equal(out, ref),
                      f"K3 {tab} row {i} {tag}: not bitwise equal to the "
                      f"plain version (max |diff| {diff})")
                check(torch.equal(out[frozen], z[frozen]),
                      f"K3 {tab} row {i} {tag}: the h = 0 row moved")
            for tab in (HEUN_EULER, DOPRI5):
                kk = k[:tab.stages].contiguous()
                args = (z, kk, h, tab.b, tab.b_err)
                zn4, p4 = rk_stage.rk_stage_combine_err_batched(
                    *args, 1e-2, 1e-2)
                zp, sqp = rk_stage.combine_err_batched_plain(
                    *args, 1e-2, 1e-2)
                torch.cuda.synchronize()
                diff = float((zn4.float() - zp.float()).abs().max())
                worst["rk_stage_combine_err_batched"] = max(
                    worst["rk_stage_combine_err_batched"], diff)
                check(torch.equal(zn4, zp),
                      f"K4 {tab.name} {tag}: z_next not bitwise equal "
                      f"(max |diff| {diff})")
                norms_close(p4, sqp, f"K4 {tab.name} {tag}")
                check(torch.equal(zn4[frozen], z[frozen])
                      and float(p4[frozen].abs().sum()) == 0.0,
                      f"K4 {tab.name} {tag}: the h = 0 row moved")
                zn5, p5 = rk_stage.rk_stage_combine_err_batched_rowtol(
                    *args, torch.full((B,), 1e-2, device="cuda"),
                    torch.full((B,), 1e-2, device="cuda"))
                torch.cuda.synchronize()
                check(torch.equal(zn5, zn4) and torch.equal(p5, p4),
                      f"K5 {tab.name} {tag}: at K4's tolerance not bitwise "
                      "K4")
                zn5, p5 = rk_stage.rk_stage_combine_err_batched_rowtol(
                    *args, rt, at)
                zp, sqp = rk_stage.combine_err_batched_plain(*args, rt, at)
                torch.cuda.synchronize()
                diff = float((zn5.float() - zp.float()).abs().max())
                worst["rk_stage_combine_err_batched_rowtol"] = max(
                    worst["rk_stage_combine_err_batched_rowtol"], diff)
                check(torch.equal(zn5, zp),
                      f"K5 {tab.name} {tag}: z_next not bitwise equal "
                      f"(max |diff| {diff})")
                norms_close(p5, sqp, f"K5 {tab.name} {tag}")
                paths = tile_checks(tab, z, kk, tag)
            cases.append({"rows": B, "n": n,
                          "dtype": str(dtype).replace("torch.", ""),
                          "k3_rows": len(rows), "bitwise": True,
                          "frozen_row_bitwise": True,
                          "k5_equal_tol_is_k4": True,
                          "tile_partials_bitwise": True,
                          "k4_k5_row_same_bits_at_b_8_3_1_and_offsets_0_3":
                          True, "k4_k5_vector_path": paths})
    emit({"phase": "kernels_batched", "ok": True, "cases": cases,
          "max_abs_err": worst, "row_norm_rtol": ROW_NORM_RTOL})

    # times at the batched paths' shapes, f32: (8, 393,216) is the
    # batch_axis=0 block state, (8, 393,218) the serving state
    timings = {}
    for n in (ROW_N, SERVE_ROW_N):
        z = torch.randn(B, n, generator=gen, device="cuda")
        k = torch.randn(7, B, n, generator=gen, device="cuda")
        h = torch.linspace(0.01, 0.08, B, device="cuda")

        def k3_entry(label, a, rows_k):
            kk = k[:rows_k].contiguous()
            used = rk_stage.used_stages(a[:rows_k])
            hw = (h[:, None] * torch.tensor(a[:rows_k], device="cuda"))[
                :, None]                                    # (B, 1, j)
            kt, zb = kk.permute(1, 0, 2), z[:, None]        # (B, j, n)
            timings[f"{label}_{n}"] = {
                "n": n,
                "ms": time_ms(torch, lambda: rk_stage.
                              rk_stage_increment_batched(z, kk, h, a)),
                "plain_ms": time_ms(torch, lambda: rk_stage.
                                    increment_batched_plain(z, kk, h, a)),
                "library_ms": time_ms(torch, lambda: torch.baddbmm(
                    zb, hw, kt)),
            }
            _bound(timings[f"{label}_{n}"],
                   rk_stage.increment_work(B, n, used))

        def comb_entry(label, tab, row_tol, rows=B):
            zz = z[:rows].contiguous()
            kk = k[:tab.stages, :rows].contiguous()
            hh = h[:rows].contiguous()
            used = rk_stage.used_stages(tab.b, tab.b_err)
            tols = (rt[:rows].contiguous(), at[:rows].contiguous()) \
                if row_tol else (1e-2, 1e-2)
            fn = rk_stage.rk_stage_combine_err_batched_rowtol if row_tol \
                else rk_stage.rk_stage_combine_err_batched
            timings[f"{label}_{n}"] = {
                "n": n, "rows": rows,
                "ms": time_ms(torch, lambda: fn(zz, kk, hh, tab.b, tab.b_err,
                                                *tols)),
                "plain_ms": time_ms(torch, lambda: rk_stage.
                                    combine_err_batched_plain(
                                        zz, kk, hh, tab.b, tab.b_err, *tols)),
                "library_ms": None,
            }
            _bound(timings[f"{label}_{n}"],
                   rk_stage.combine_err_batched_work(rows, n, used,
                                                     row_tol=row_tol))

        k3_entry("k3_heun_stage", HEUN_EULER.a[1], 1)   # every trial
        k3_entry("k3_heun_b", HEUN_EULER.b, 2)          # ACA replay
        k3_entry("k3_dopri5_b", DOPRI5.b, 7)
        comb_entry("k4_heun", HEUN_EULER, False)
        comb_entry("k4_dopri5", DOPRI5, False)
        comb_entry("k5_heun", HEUN_EULER, True)
        comb_entry("k5_dopri5", DOPRI5, True)
        comb_entry("k5_heun_b1", HEUN_EULER, True, rows=1)  # one request
    for t in timings.values():
        t["achieved_GBps"] = t["bytes"] / (t["ms"] * 1e-3) / 1e9
    emit({"phase": "kernel_times_batched", "ok": True, "rows": B,
          "dtype": "float32", "timings": timings})
    return worst, timings


def _parity_bound(res, req, ref_max: float) -> float:
    """The reference's chunked-serving parity bound (docs/serving.md)."""
    return (res.n_chunks + 1) * (req.atol + req.rtol * max(1.0, ref_max))


def _node18_serving(torch, seed: int, static: bool):
    """The node18 serving engine (8 slots over the block's residual branch,
    HeunEuler, K3/K5) with its 16 seeded requests submitted: (engine,
    requests, arrivals, field, params). ``static`` picks the static-batch
    scheduler."""
    import numpy as np

    from repro_torch.configs import node18_cifar
    from repro_torch.models.config import RunConfig
    from repro_torch.models.transformer import TransformerBlock, branch_fn
    from repro_torch.serve import (
        NodeEngineConfig,
        NodeRequest,
        NodeServeEngine,
    )

    block = TransformerBlock(node18_cifar.CONFIG,
                             RunConfig(compute_dtype=torch.float32),
                             seed=seed, device="cuda")
    params = {n: p.detach() for n, p in block.named_parameters()}
    sample = (1,) + NODE18_SHAPE[1:]

    def field(t, z, p):
        # one request's flat (512*768,) state as a batch of one sample
        return branch_fn(block, p, z.reshape(sample)).reshape(-1)

    ecfg = NodeEngineConfig(slots=BATCH_ROWS, solver="heun_euler",
                            chunk_dt=0.5, max_steps=64, use_pallas=True,
                            static_batch=static)
    engine = NodeServeEngine(field, ROW_N, (params,), ecfg, device="cuda")
    rng = np.random.default_rng(seed + 2)
    arrivals = np.cumsum(rng.exponential(2.0, SERVE_REQUESTS))
    reqs = []
    for _ in range(SERVE_REQUESTS):
        tol = float(rng.choice([1e-2, 1e-3]))
        reqs.append(NodeRequest(
            z0=rng.standard_normal(ROW_N).astype(np.float32), t0=0.0,
            t1=float(rng.choice([0.5, 1.0])), rtol=tol, atol=tol))
    for i, req in enumerate(reqs):
        engine.submit(req, arrival=float(arrivals[i]))
    return engine, reqs, arrivals, field, params


def _serve_rounds(torch, engine, label: str):
    """Drain ``engine`` one round at a time, each round timed on the host
    clock after a synchronize: (round rows, drain seconds, launches). The
    launch counts are set to 0 just before and read just after."""
    from repro_torch.kernels import ops, rk_stage

    rounds = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                   # the main path starts here
    t_start = time.perf_counter()
    while True:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = engine.step()
        torch.cuda.synchronize()
        if not more:
            break
        row = {"round": engine.round - 1, "live": engine.occupancy_log[-1],
               "max_trials": engine.trials_log[-1],
               "wall_ms": 1e3 * (time.perf_counter() - t0)}
        rounds.append(row)
        emit({"phase": label, **row})
    wall_s = time.perf_counter() - t_start
    launches = dict(rk_stage.launches)     # the main path ends here
    return rounds, wall_s, launches


def phase_serve_node18(torch, seed: int):
    import numpy as np

    from repro_torch.configs import node18_cifar
    from repro_torch.core import odeint

    engine, reqs, arrivals, field, params = _node18_serving(torch, seed,
                                                            False)
    ecfg = engine.cfg
    rounds, wall_s, launches = _serve_rounds(torch, engine, "serve_round")
    peak = torch.cuda.max_memory_allocated() / 1e9
    results = [engine.results[i] for i in sorted(engine.results)]
    check(len(results) == SERVE_REQUESTS,
          f"serve: {len(results)} of {SERVE_REQUESTS} requests delivered")
    check(all(launches[k] > 0 for k in SERVE_KERNELS),
          f"serve: the rounds did not launch K3 and K5: {launches}")

    per_req = []
    with torch.no_grad():
        for res, req in zip(results, reqs):
            ys, st = odeint(field, torch.from_numpy(req.z0).cuda(),
                            [0.0, req.t1], (params,), solver="heun_euler",
                            rtol=req.rtol, atol=req.atol, max_steps=256,
                            use_pallas=True)
            ref = ys[-1].cpu().numpy()
            err = float(np.abs(res.z_final - ref).max())
            bound = _parity_bound(res, req, float(np.abs(ref).max()))
            per_req.append({"id": res.req_id, "t1": req.t1, "tol": req.rtol,
                            "status": res.status, "ok": res.ok,
                            "n_chunks": res.n_chunks,
                            "n_trials": res.n_trials,
                            "latency_sim": res.latency,
                            "solo_n_trials": int(st.n_trials),
                            "parity_err": err, "parity_bound": bound})

    # QoS isolation: the request that shared its admission round with the
    # most rows, served again alone
    admitted = {rid: rd for rd, _, rid in engine.admission_log}
    victim = max(sorted(admitted),
                 key=lambda rid: engine.occupancy_log[admitted[rid]])
    rows_in_mix = engine.occupancy_log[admitted[victim]]
    mixed = engine.results[victim]
    engine.reset()
    engine.submit(reqs[victim], arrival=float(arrivals[victim]))
    alone = engine.run()[0]
    qos = {"request": victim, "rows_in_mix": rows_in_mix,
           "bitwise": bool(np.array_equal(alone.z_final, mixed.z_final)),
           "n_trials": [alone.n_trials, mixed.n_trials],
           "max_abs_diff": float(np.abs(alone.z_final
                                        - mixed.z_final).max())}
    emit({"phase": "serve_node18", "ok": True,
          "d_model": node18_cifar.CONFIG.d_model, "slots": ecfg.slots,
          "solver": ecfg.solver, "chunk_dt": ecfg.chunk_dt,
          "state_row": ROW_N + 2, "requests": per_req, "rounds": len(rounds),
          "wall_s": wall_s, "round_ms": [r["wall_ms"] for r in rounds],
          "launches": {k: launches[k] for k in launches if launches[k]},
          "peak_mem_GB": peak, "qos_isolation": qos})
    check(all(r["ok"] for r in per_req),
          f"serve: requests not OK: {[r for r in per_req if not r['ok']]}")
    far = [r for r in per_req if not r["parity_err"] <= r["parity_bound"]]
    check(not far, f"serve: beyond the parity bound: {far}")
    check(qos["bitwise"] and alone.n_trials == mixed.n_trials,
          f"serve: QoS isolation broken, alone vs mix: {qos}")
    return launches, rounds


def phase_node18_batched(torch, seed: int):
    import dataclasses

    from repro_torch.configs import node18_cifar
    from repro_torch.models.transformer import full_buffer
    ncfg = dataclasses.replace(full_buffer(node18_cifar.NODE_TRAIN),
                               batch_axis=0)
    return _node18_train(torch, seed, ncfg, 2, BATCHED_KERNELS,
                         "node18_batched")


def _aug_kernel_checks(torch, seed: int, n_aug: int, row_aug: int):
    """K1/K2 at the solo adjoint's augmented state (n_aug,) and K3/K4 at
    the batched adjoint's (8, row_aug), HeunEuler's rows, f32: outputs
    bitwise their plain versions, norm sums within NORM_RTOL /
    ROW_NORM_RTOL; times beside the byte bound and the plain version.
    These launches compare, they are not a path's: the caller resets the
    counts after."""
    from repro_torch.core.tableaus import HEUN_EULER as tab
    from repro_torch.kernels import rk_stage
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    worst, times = {}, {}
    a1, b = tab.a[1], tab.b

    def keep(name, diff):
        worst[name] = max(worst.get(name, 0.0), diff)

    def timing(label, fn, plain, work):
        times[label] = _bound({"ms": time_ms(torch, fn, iters=10),
                               "plain_ms": time_ms(torch, plain, iters=10)},
                              work)

    z = torch.randn(n_aug, generator=gen, device="cuda")
    k = torch.randn(2, n_aug, generator=gen, device="cuda")
    h = torch.full((), 0.0375, device="cuda")
    for i, w in ((1, a1), (2, b)):
        kk = k[:i].contiguous()
        out = rk_stage.rk_stage_increment(z, kk, h, w)
        ref = rk_stage.increment_plain(z, kk, h, w)
        torch.cuda.synchronize()
        keep("rk_stage_increment", float((out - ref).abs().max()))
        check(torch.equal(out, ref), f"K1 at N = {n_aug}: not bitwise")
    zn, _, part = rk_stage.rk_stage_combine_err(
        z, k, h, b, tab.b_err, 1e-2, 1e-2, with_err=False)
    zn_p, _, sq_p = rk_stage.combine_err_plain(z, k, h, b, tab.b_err, 1e-2,
                                               1e-2, False)
    torch.cuda.synchronize()
    keep("rk_stage_combine_err", float((zn - zn_p).abs().max()))
    check(torch.equal(zn, zn_p), f"K2 at N = {n_aug}: z_next not bitwise")
    sq, sqp = float(part.sum()), float(sq_p.sum())
    check(abs(sq - sqp) <= NORM_RTOL * abs(sqp),
          f"K2 at N = {n_aug}: norm {sq} vs {sqp}")
    k1 = k[:1].contiguous()
    timing("k1", lambda: rk_stage.rk_stage_increment(z, k1, h, a1),
           lambda: rk_stage.increment_plain(z, k1, h, a1),
           rk_stage.increment_work(1, n_aug, 1))
    timing("k2", lambda: rk_stage.rk_stage_combine_err(
        z, k, h, b, tab.b_err, 1e-2, 1e-2, with_err=False),
        lambda: rk_stage.combine_err_plain(z, k, h, b, tab.b_err, 1e-2,
                                           1e-2, False),
        rk_stage.combine_err_work(n_aug, 2, with_err=False))
    del z, k

    B = BATCH_ROWS
    z = torch.randn(B, row_aug, generator=gen, device="cuda")
    k = torch.randn(2, B, row_aug, generator=gen, device="cuda")
    hb = torch.linspace(0.01, 0.08, B, device="cuda")
    for i, w in ((1, a1), (2, b)):
        kk = k[:i].contiguous()
        out = rk_stage.rk_stage_increment_batched(z, kk, hb, w)
        ref = rk_stage.increment_batched_plain(z, kk, hb, w)
        torch.cuda.synchronize()
        keep("rk_stage_increment_batched", float((out - ref).abs().max()))
        check(torch.equal(out, ref), f"K3 at ({B}, {row_aug}): not bitwise")
    zn, part = rk_stage.rk_stage_combine_err_batched(z, k, hb, b, tab.b_err,
                                                     1e-2, 1e-2)
    zn_p, sq_p = rk_stage.combine_err_batched_plain(z, k, hb, b, tab.b_err,
                                                    1e-2, 1e-2)
    torch.cuda.synchronize()
    keep("rk_stage_combine_err_batched", float((zn - zn_p).abs().max()))
    check(torch.equal(zn, zn_p), f"K4 at ({B}, {row_aug}): z_next not "
          "bitwise")
    sq, sqp = part.sum(dim=-1), sq_p.reshape(-1)
    check(bool(((sq - sqp).abs() <= ROW_NORM_RTOL * sqp.abs()).all()),
          f"K4 at ({B}, {row_aug}): per-row norms {sq.tolist()} vs "
          f"{sqp.tolist()}")
    k1 = k[:1].contiguous()
    timing("k3", lambda: rk_stage.rk_stage_increment_batched(z, k1, hb, a1),
           lambda: rk_stage.increment_batched_plain(z, k1, hb, a1),
           rk_stage.increment_work(B, row_aug, 1))
    timing("k4", lambda: rk_stage.rk_stage_combine_err_batched(
        z, k, hb, b, tab.b_err, 1e-2, 1e-2),
        lambda: rk_stage.combine_err_batched_plain(z, k, hb, b, tab.b_err,
                                                   1e-2, 1e-2),
        rk_stage.combine_err_batched_work(B, row_aug, 2))
    return worst, times


def phase_node18_methods(torch, seed: int):
    """The paper's three gradient methods on one node18 block at full
    width: one SGD step each from the same weights and input (the main
    path, solo, kernels K1/K2), each against its plain path; the fixed
    regime (rk2) with ACA and naive; adjoint and naive under
    batch_axis=0 (K3/K4); K1-K4 at the adjoint's augmented shapes."""
    import dataclasses
    import importlib

    import numpy as np

    from repro_torch.configs import node18_cifar
    from repro_torch.kernels import ops, rk_stage
    from repro_torch.models.config import RunConfig
    from repro_torch.models.transformer import (TransformerBlock, full_buffer,
                                                node_block)

    adjoint_mod = importlib.import_module("repro_torch.core.odeint_adjoint")
    base = full_buffer(node18_cifar.NODE_TRAIN)
    rcfg = RunConfig(compute_dtype=torch.float32, node=base)
    block = TransformerBlock(node18_cifar.CONFIG, rcfg, seed=seed,
                             device="cuda")
    init = {n: p.detach().clone() for n, p in block.named_parameters()}
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        NODE18_SHAPE).astype(np.float32)).cuda()
    n_params = sum(p.numel() for p in block.parameters())
    opt = torch.optim.SGD(block.parameters(), lr=1e-2)

    # the adjoint's reverse segments: each engine call's stats, read
    # around the backward (instrumentation; the solver is unchanged)
    engine_stats = []

    def recording(engine):
        def wrapped(*a, **kw):
            out = engine(*a, **kw)
            engine_stats.append(out[2])
            return out
        return wrapped

    for name in ("adaptive_while_solve", "batched_adaptive_while_solve"):
        setattr(adjoint_mod, name, recording(getattr(adjoint_mod, name)))

    def sgd_step(ncfg):
        """One SGD step from the initial weights: z(T), stats, gradients,
        times, peak memory, the reverse solve's segments."""
        with torch.no_grad():
            for n, p in block.named_parameters():
                p.copy_(init[n])
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        zT, st = node_block(block, x, ncfg)
        loss = torch.mean(zT ** 2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n_before = len(engine_stats)
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        reverse = engine_stats[n_before:]
        grads = {n: p.grad.detach().clone()
                 for n, p in block.named_parameters()}
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return {"zT": zT.detach(), "st": st, "grads": grads,
                "forward_ms": 1e3 * (t1 - t0),
                "backward_ms": 1e3 * (t2 - t1),
                "step_ms": 1e3 * (t3 - t0),
                "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
                "peak_above_start_GB":
                (torch.cuda.max_memory_allocated() - base_mem) / 1e9,
                "reverse_steps": [s.n_steps.tolist() for s in reverse],
                "reverse_trials": [s.n_trials.tolist() for s in reverse]}

    def summary(r):
        st = r["st"]
        return {k: r[k] for k in ("forward_ms", "backward_ms", "step_ms",
                                  "peak_mem_GB", "peak_above_start_GB",
                                  "reverse_steps", "reverse_trials")} | {
            "n_steps": st.n_steps.tolist(), "n_trials": st.n_trials.tolist(),
            "nfe": st.nfe.tolist(), "status": st.status.tolist()}

    def grad_rel(ra, rb):
        return {n: _rel(ra["grads"][n], rb["grads"][n]) for n in rb["grads"]}

    def finite(r):
        return bool(torch.isfinite(r["zT"]).all()) and all(
            bool(torch.isfinite(g).all()) for g in r["grads"].values())

    methods = ("aca", "adjoint", "naive")
    # a first step of each method grows the caching allocator to the
    # method's peak (the naive's tape needs GBs more than ACA's): timed
    # apart, as a training run's first step is
    first_ms = {m: sgd_step(dataclasses.replace(base, grad_method=m))[
        "step_ms"] for m in methods}
    # the main path: one step of each method on the kernels
    fused = {}
    torch.cuda.synchronize()
    ops.reset_launches()
    for m in methods:
        before = dict(rk_stage.launches)
        fused[m] = sgd_step(dataclasses.replace(base, grad_method=m))
        fused[m]["launches"] = {k: rk_stage.launches[k] - before[k]
                                for k in K1_K2}
        emit({"phase": "node18_methods_step", "method": m,
              **summary(fused[m]), "launches": fused[m]["launches"]})
    launches = dict(rk_stage.launches)
    check(all(launches[k] > 0 for k in K1_K2),
          f"node18_methods did not launch K1 and K2: {launches}")
    for m in methods:
        check(finite(fused[m]), f"node18_methods {m}: non-finite z(T) or "
              "gradients")
        check(fused[m]["st"].status.tolist() == 0,
              f"node18_methods {m}: status {fused[m]['st'].status.tolist()}")
    steps = {m: fused[m]["st"].n_steps.tolist() for m in methods}
    check(len(set(steps.values())) == 1,
          f"node18_methods: n_steps differ across methods {steps}")
    check(torch.equal(fused["adjoint"]["zT"], fused["aca"]["zT"]),
          "node18_methods: the adjoint's z(T) is not ACA's bit for bit")
    naive_z = _rel(fused["naive"]["zT"], fused["aca"]["zT"])
    check(naive_z <= NODE_RTOL,
          f"node18_methods: naive z(T) {naive_z} from ACA's > {NODE_RTOL}")

    # each method on the plain path against its fused step
    plain_rel = {}
    for m in methods:
        r = sgd_step(dataclasses.replace(base, grad_method=m,
                                         use_pallas=False))
        check(r["st"].n_steps.tolist() == steps[m],
              f"node18_methods {m}: plain n_steps "
              f"{r['st'].n_steps.tolist()} != fused {steps[m]}")
        rel = {"z1": _rel(fused[m]["zT"], r["zT"]),
               **grad_rel(fused[m], r)}
        plain_rel[m] = rel
        bad = {k: v for k, v in rel.items() if not v <= NODE_RTOL}
        check(finite(r) and not bad,
              f"node18_methods {m}: fused vs plain beyond {NODE_RTOL}: "
              f"{bad}")
        del r

    # the fixed regime: ACA and naive differentiate one discrete solution
    fixed, fixed_launches = {}, {}
    ops.reset_launches()
    for m in ("aca", "naive"):
        fixed[m] = sgd_step(dataclasses.replace(base, grad_method=m,
                                                regime="fixed"))
        check(finite(fixed[m]), f"node18_methods fixed {m}: non-finite")
    fixed_launches = {k: rk_stage.launches[k] for k in K1_K2}
    check(fixed_launches["rk_stage_increment"] > 0,
          f"the fixed regime did not launch K1: {fixed_launches}")
    fixed_rel = grad_rel(fixed["naive"], fixed["aca"])
    fixed_z = _rel(fixed["naive"]["zT"], fixed["aca"]["zT"])
    bad = {k: v for k, v in fixed_rel.items()
           if not v <= FIXED_ACA_NAIVE_RTOL}
    check(not bad, f"node18_methods fixed: ACA vs naive gradients beyond "
          f"{FIXED_ACA_NAIVE_RTOL}: {bad}")

    # batch_axis=0: the adjoint and naive methods per row on K3/K4
    batched = {}
    ops.reset_launches()
    for m in ("adjoint", "naive"):
        batched[m] = sgd_step(dataclasses.replace(base, grad_method=m,
                                                  batch_axis=0))
        check(finite(batched[m]), f"node18_methods batched {m}: non-finite")
        check(not any(batched[m]["st"].status.tolist()),
              f"node18_methods batched {m}: status "
              f"{batched[m]['st'].status.tolist()}")
    batched_launches = {k: rk_stage.launches[k] for k in BATCHED_KERNELS}
    check(all(v > 0 for v in batched_launches.values()),
          f"the batched methods did not launch K3 and K4: "
          f"{batched_launches}")
    batched_rel = grad_rel(batched["naive"], batched["adjoint"])

    n_aug = 2 * x.numel() + n_params
    row_aug = 2 * ROW_N + n_params
    worst, aug_times = _aug_kernel_checks(torch, seed, n_aug, row_aug)
    ops.reset_launches()

    emit({"phase": "node18_methods", "ok": True,
          "shape": list(NODE18_SHAPE), "n_params": n_params,
          "solver": base.solver, "rtol": base.rtol, "atol": base.atol,
          "methods": {m: summary(fused[m]) for m in methods},
          "first_step_ms": first_ms,
          "launches": {m: fused[m]["launches"] for m in methods},
          "naive_z1_vs_aca": naive_z,
          "naive_z1_bitwise_aca": torch.equal(fused["naive"]["zT"],
                                              fused["aca"]["zT"]),
          "grad_rel_vs_aca": {m: grad_rel(fused[m], fused["aca"])
                              for m in ("adjoint", "naive")},
          "fused_vs_plain": {"max_rel": plain_rel, "rtol": NODE_RTOL},
          "fixed": {"solver": "rk2",
                    "steps_per_interval": base.steps_per_interval,
                    "methods": {m: summary(fixed[m]) for m in fixed},
                    "naive_vs_aca_grad_rel": fixed_rel,
                    "naive_vs_aca_z1": fixed_z,
                    "rtol": FIXED_ACA_NAIVE_RTOL,
                    "launches": fixed_launches},
          "batched": {"methods": {m: summary(batched[m]) for m in batched},
                      "naive_vs_adjoint_grad_rel": batched_rel,
                      "launches": batched_launches},
          "aug_kernels": {"n_aug": n_aug, "row_aug": row_aug,
                          "max_abs_err": worst, "timings": aug_times}})
    path_launches = {
        k: launches.get(k, 0) + fixed_launches.get(k, 0)
        + batched_launches.get(k, 0)
        for k in K1_K2 + BATCHED_KERNELS}
    return path_launches, worst, aug_times


# ------------------------------------------ slice D: segments, dense output

DENSE_LANDED_ATOL = 5e-4         # tests/test_dense_output.py:126, rtol 1e-5
DENSE_PALLAS_ATOL = 2e-5         # tests/test_dense_output.py:163-164
DENSE_QUERIES = 1000
LATENT_BATCH = 48


def _bmid_kernel_checks(torch, seed: int):
    """K1 with Dopri5's 7-weight ``b_mid`` row at N = 3,145,728 and K3 with
    it at (8, 393,216) and (8, 393,218), f32 and bf16: bitwise their plain
    versions; f32 times beside the byte bound, the plain version and the
    library call (``torch.addmv``, ``torch.baddbmm``). These launches
    compare: the caller resets the counts after."""
    from repro_torch.core.tableaus import DOPRI5
    from repro_torch.kernels import rk_stage
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    a = DOPRI5.b_mid
    used = rk_stage.used_stages(a)
    worst = {"rk_stage_increment": 0.0, "rk_stage_increment_batched": 0.0}
    times = {}
    n1 = math.prod(NODE18_SHAPE)
    for dtype in (torch.float32, torch.bfloat16):
        z = torch.randn(n1, generator=gen, device="cuda").to(dtype)
        k = torch.randn(7, n1, generator=gen, device="cuda").to(dtype)
        h = torch.full((), 0.0375, device="cuda")
        out = rk_stage.rk_stage_increment(z, k, h, a)
        ref = rk_stage.increment_plain(z, k, h, a)
        torch.cuda.synchronize()
        diff = float((out.float() - ref.float()).abs().max())
        worst["rk_stage_increment"] = max(worst["rk_stage_increment"], diff)
        check(torch.equal(out, ref), f"K1 b_mid n={n1} {dtype}: not bitwise "
              f"(max |diff| {diff})")
        if dtype == torch.float32:
            hw = h * torch.tensor(a, dtype=torch.float32, device="cuda")
            kt = k.t()
            t = {"n": n1, "ms": time_ms(torch, lambda: rk_stage.
                                        rk_stage_increment(z, k, h, a)),
                 "plain_ms": time_ms(torch, lambda: rk_stage.increment_plain(
                     z, k, h, a)),
                 "library_ms": time_ms(torch, lambda: torch.addmv(z, kt, hw))}
            _bound(t, rk_stage.increment_work(1, n1, used))
            times["k1_b_mid"] = t
        del z, k
    B = BATCH_ROWS
    for n in (ROW_N, SERVE_ROW_N):
        for dtype in (torch.float32, torch.bfloat16):
            z = torch.randn(B, n, generator=gen, device="cuda").to(dtype)
            k = torch.randn(7, B, n, generator=gen, device="cuda").to(dtype)
            h = torch.linspace(0.01, 0.08, B, device="cuda")
            h[B // 2] = 0.0                          # a frozen row
            out = rk_stage.rk_stage_increment_batched(z, k, h, a)
            ref = rk_stage.increment_batched_plain(z, k, h, a)
            torch.cuda.synchronize()
            diff = float((out.float() - ref.float()).abs().max())
            worst["rk_stage_increment_batched"] = max(
                worst["rk_stage_increment_batched"], diff)
            check(torch.equal(out, ref) and torch.equal(out[B // 2],
                                                        z[B // 2]),
                  f"K3 b_mid ({B}, {n}) {dtype}: not bitwise (max |diff| "
                  f"{diff}) or the h = 0 row moved")
            if dtype == torch.float32:
                hw = (h[:, None] * torch.tensor(a, device="cuda"))[:, None]
                kt, zb = k.permute(1, 0, 2), z[:, None]
                t = {"n": n, "rows": B,
                     "ms": time_ms(torch, lambda: rk_stage.
                                   rk_stage_increment_batched(z, k, h, a)),
                     "plain_ms": time_ms(torch, lambda: rk_stage.
                                         increment_batched_plain(z, k, h, a)),
                     "library_ms": time_ms(torch, lambda: torch.baddbmm(
                         zb, hw, kt))}
                _bound(t, rk_stage.increment_work(B, n, used))
                times[f"k3_b_mid_{n}"] = t
            del z, k
    return worst, times


def _grad_gap(torch, seg: dict, full_a: dict, full_b: dict, what: str):
    """Hold a segmented run to the full buffer's: z(1) and every gradient
    within the full buffer's own run-to-run gap (max |full_a - full_b|, 0
    where the card repeats itself bit for bit: then bitwise). Returns
    {name: [max |seg - full_a|, gap]}."""
    out = {}
    pairs = [("z1", seg["zT"], full_a["zT"], full_b["zT"])]
    pairs += [(n, seg["grads"][n], full_a["grads"][n], full_b["grads"][n])
              for n in full_a["grads"]]
    for name, s_, a_, b_ in pairs:
        gap = float((a_ - b_).abs().max())
        d = float((s_ - a_).abs().max())
        out[name] = [d, gap]
        check(d <= gap, f"{what} {name}: segmented differs from the full "
              f"buffer by {d}, beyond its run-to-run gap {gap}")
    return out


def phase_segmented_dense(torch, seed: int):
    """Slice D on the card. (a) node18 at full width with ``NODE_TRAIN`` as
    published (segmented ACA, "auto": K = 6, seg_len 6), one SGD step solo
    on K1/K2 and one under batch_axis=0 on K3/K4, each held to the full
    buffer from the same weights; (b) peak memory of ACA at 65,536 x 64
    with the full buffer and "auto" at max_steps 64 and 512, gradients
    bitwise; (c) K1/K3 with the b_mid row against their plain versions,
    ``repro_torch.benchmarks.dense_eval`` with the reference's gates,
    ``odeint_dense`` read at 1,000 times against a landing solve, and the
    latent-ODE union-grid decode at Table 4's widths against its (B, T)
    landing solve and against its plain path. The main path (K1-K4
    counted): the two NODE_TRAIN steps, the dense solve and the decode."""
    import dataclasses

    import numpy as np

    from repro_torch.benchmarks import dense_eval, method_costs, timeseries
    from repro_torch.configs import node18_cifar
    from repro_torch.core import odeint, odeint_dense
    from repro_torch.core.integrate import resolve_segmentation
    from repro_torch.data import irregular_series_batch, merged_time_grid
    from repro_torch.examples.latent_timeseries import union_decode
    from repro_torch.kernels import ops, rk_stage
    from repro_torch.models.config import RunConfig
    from repro_torch.models.transformer import (TransformerBlock, full_buffer,
                                                node_block)

    worst, bmid_times = _bmid_kernel_checks(torch, seed)
    ops.reset_launches()

    # (a) node18 as published against the full buffer
    seg_cfg = node18_cifar.NODE_TRAIN
    full_cfg = full_buffer(seg_cfg)
    n_seg, seg_len = resolve_segmentation(seg_cfg.checkpoint_segments,
                                          seg_cfg.max_steps)
    rcfg = RunConfig(compute_dtype=torch.float32, node=seg_cfg)
    block = TransformerBlock(node18_cifar.CONFIG, rcfg, seed=seed,
                             device="cuda")
    init = {n: p.detach().clone() for n, p in block.named_parameters()}
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        NODE18_SHAPE).astype(np.float32)).cuda()
    opt = torch.optim.SGD(block.parameters(), lr=1e-2)

    def sgd_step(ncfg):
        with torch.no_grad():
            for n, p in block.named_parameters():
                p.copy_(init[n])
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        zT, st = node_block(block, x, ncfg)
        loss = torch.mean(zT ** 2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        k_before = dict(rk_stage.launches)
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        bwd_launches = {k: rk_stage.launches[k] - k_before[k]
                        for k in K1_K2 + BATCHED_KERNELS}
        grads = {n: p.grad.detach().clone()
                 for n, p in block.named_parameters()}
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        finite = bool(torch.isfinite(zT).all()) and all(
            bool(torch.isfinite(g).all()) for g in grads.values())
        check(finite, f"segmented_dense node18 {ncfg.checkpoint_segments} "
              f"batch_axis={ncfg.batch_axis}: non-finite z(1) or gradients")
        check(not any(st.status.reshape(-1).tolist()),
              f"segmented_dense node18: status {st.status.tolist()}")
        return {"zT": zT.detach(), "grads": grads,
                "n_steps": st.n_steps.tolist(),
                "n_trials": st.n_trials.tolist(), "nfe": st.nfe.tolist(),
                "forward_ms": 1e3 * (t1 - t0), "backward_ms": 1e3 * (t2 - t1),
                "step_ms": 1e3 * (t3 - t0),
                "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
                "peak_above_start_GB":
                (torch.cuda.max_memory_allocated() - base_mem) / 1e9,
                "backward_launches": bwd_launches}

    def summary(r):
        return {k: v for k, v in r.items() if k not in ("zT", "grads")}

    cfgs = {"solo": (full_cfg, seg_cfg),
            "batched": (dataclasses.replace(full_cfg, batch_axis=0),
                        dataclasses.replace(seg_cfg, batch_axis=0))}
    # an untimed first step each grows the allocator to its peak
    first_ms = {f"{mode}_{name}": sgd_step(c)["step_ms"]
                for mode, pair in cfgs.items()
                for name, c in zip(("full", "segmented"), pair)}
    full = {mode: (sgd_step(pair[0]), sgd_step(pair[0]))
            for mode, pair in cfgs.items()}
    torch.cuda.synchronize()
    ops.reset_launches()                   # the main path starts here
    seg = {mode: sgd_step(pair[1]) for mode, pair in cfgs.items()}
    node18 = {}
    for mode in cfgs:
        fa, fb = full[mode]
        check(seg[mode]["n_steps"] == fa["n_steps"],
              f"segmented_dense node18 {mode}: n_steps "
              f"{seg[mode]['n_steps']} != full buffer's {fa['n_steps']}")
        gaps = _grad_gap(torch, seg[mode], fa, fb, f"node18 {mode}")
        node18[mode] = {
            "full": summary(fa), "full_again": summary(fb),
            "segmented": summary(seg[mode]),
            "bitwise": all(d == 0.0 for d, _ in gaps.values()),
            "full_run_to_run_gap": max(g for _, g in gaps.values()),
            "max_abs_vs_full": max(d for d, _ in gaps.values()),
            "extra_backward_launches": {
                k: seg[mode]["backward_launches"][k]
                - fa["backward_launches"][k] for k in fa["backward_launches"]}}
        emit({"phase": "segmented_dense_node18", "mode": mode,
              **node18[mode]})
    del full, seg, block, opt, init

    # (c) the dense solve and the latent decode on the kernels (main path)
    dev = "cuda"
    z0 = torch.tensor([2.0, 0.0], device=dev)
    mu = torch.tensor(dense_eval.MU, device=dev)
    tq = torch.linspace(0.0, dense_eval.T1, DENSE_QUERIES, device=dev)
    dkw = dict(rtol=dense_eval.TOL, atol=dense_eval.TOL, max_steps=4096,
               max_trials=20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol, dst = odeint_dense(dense_eval._vdp, z0, 0.0, dense_eval.T1, (mu,),
                            use_pallas=True, **dkw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    vals = sol.evaluate(tq)
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    p = timeseries.init_params(torch.Generator().manual_seed(0), dev)
    data = irregular_series_batch(batch=LATENT_BATCH, n_obs=timeseries.N_OBS,
                                  obs_dim=timeseries.OBS, seed=123,
                                  device=dev)
    n_union = int(merged_time_grid(data["ts"])["t_union"].shape[0])

    def decode_grad(use_pallas):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred, st = union_decode(p, data, rtol=1e-5, use_pallas=use_pallas)
        loss = ((pred - data["ys"]) ** 2).mean()
        grads = torch.autograd.grad(loss, list(p.values()))
        torch.cuda.synchronize()
        return pred.detach(), st, grads, 1e3 * (time.perf_counter() - t0)

    pred_k, st_k, g_k, decode_ms = decode_grad(True)
    launches = {k: rk_stage.launches[k] for k in K1_K2 + BATCHED_KERNELS}
    check(all(v > 0 for v in launches.values()),
          f"segmented_dense did not launch K1-K4: {launches}")
    # the main path ends here

    with torch.no_grad():
        t3 = time.perf_counter()
        ys_land, lst = odeint(dense_eval._vdp, z0, tq, (mu,),
                              solver="dopri5", **dkw)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    dense_err = float((vals - ys_land).abs().max())
    check(not bool(dst.overflow) and dense_err <= DENSE_LANDED_ATOL,
          f"odeint_dense at {DENSE_QUERIES} times vs landing: {dense_err} > "
          f"{DENSE_LANDED_ATOL} (overflow {bool(dst.overflow)})")

    pred_p, st_p, g_p, decode_plain_ms = decode_grad(False)
    with torch.no_grad():
        zl = timeseries.gru_encode(p, data["ts"], data["ys"])
        ys_l, st_l = odeint(timeseries._f, zl, data["ts"], (p["f1"],
                                                            p["f2"]),
                            solver="dopri5", rtol=1e-5, atol=1e-5,
                            max_steps=256, batch_axis=0, use_pallas=True)
        landed = ys_l.transpose(0, 1) @ p["dec"]
    latent = {
        "batch": LATENT_BATCH, "union_times": n_union,
        "steps_union": int(st_k.n_steps.sum()),
        "steps_landing": int(st_l.n_steps.sum()),
        "trials_union": int(st_k.n_trials.sum()),
        "trials_landing": int(st_l.n_trials.sum()),
        "max_abs_vs_landing": float((pred_k - landed).abs().max()),
        "bound": DENSE_LANDED_ATOL,
        "kernel_vs_plain": {
            "n_steps_equal": st_k.n_steps.tolist() == st_p.n_steps.tolist(),
            "max_abs": float((pred_k - pred_p).abs().max()),
            "grad_rel": [_rel(a, b) for a, b in zip(g_k, g_p)],
            "atol": DENSE_PALLAS_ATOL, "grad_rtol": PALLAS_GRAD_RTOL},
        "decode_and_grad_ms": decode_ms,
        "decode_and_grad_plain_ms": decode_plain_ms}
    check(latent["max_abs_vs_landing"] <= DENSE_LANDED_ATOL,
          f"latent union decode vs landing {latent['max_abs_vs_landing']} > "
          f"{DENSE_LANDED_ATOL}")
    check(latent["steps_union"] < latent["steps_landing"],
          f"latent union decode took {latent['steps_union']} steps, not "
          f"fewer than the landing solve's {latent['steps_landing']}")
    kvp = latent["kernel_vs_plain"]
    check(kvp["n_steps_equal"] and kvp["max_abs"] <= DENSE_PALLAS_ATOL
          and max(kvp["grad_rel"]) <= PALLAS_GRAD_RTOL
          and all(bool(torch.isfinite(g).all()) for g in g_k),
          f"latent union decode, kernels vs plain: {kvp}")

    common_rows = dense_eval.run(device="cuda")   # raises on a failed gate

    # (b) memory where the state dominates: the method_costs field
    memory = {}
    for ms in (64, 512):
        runs = {}
        for segs in (None, "auto"):
            runs[segs] = method_costs.peak_memory(
                "aca", MEMORY_ROWS, ms, device="cuda",
                checkpoint_segments=segs, with_grads=True)
        ga, gs = runs[None].pop("grads"), runs["auto"].pop("grads")
        bitwise = all(torch.equal(a, b) for a, b in zip(ga, gs))
        check(bitwise and runs[None]["n_steps"] == runs["auto"]["n_steps"],
              f"65,536 x 64 at max_steps {ms}: segmented gradients not "
              "bitwise the full buffer's")
        k, sl = resolve_segmentation("auto", ms)
        slot = MEMORY_ROWS * method_costs.D * 4
        memory[ms] = {"full": runs[None], "auto": runs["auto"],
                      "grads_bitwise": bitwise, "K": k, "seg_len": sl,
                      "full_buffer_bytes": ms * slot,
                      "auto_state_bytes": (2 * k + sl) * slot}
        del ga, gs
    ops.reset_launches()

    emit({"phase": "segmented_dense", "ok": True,
          "node18": {"K": n_seg, "seg_len": seg_len,
                     "first_step_ms": first_ms,
                     **{m: {k: v for k, v in node18[m].items()
                            if k not in ("full", "full_again")}
                        for m in node18}},
          "memory_65536x64": memory,
          "odeint_dense": {"queries": DENSE_QUERIES, "n_steps":
                           int(dst.n_steps), "solve_ms": 1e3 * (t1 - t0),
                           "evaluate_ms": 1e3 * (t2 - t1),
                           "landing_steps": int(lst.n_steps),
                           "landing_ms": 1e3 * (t4 - t3),
                           "max_abs_vs_landing": dense_err,
                           "bound": DENSE_LANDED_ATOL},
          "latent_union_decode": latent, "dense_eval": common_rows,
          "b_mid_kernels": {"max_abs_err": worst, "timings": bmid_times},
          "launches": launches})
    return launches, worst, bmid_times, memory


# ------------------------------- slices E and F: solve health and MALI

FAULT_T = 0.5
FAULT_ROWS = 8
FAULT_ROW = 3                    # the poisoned row of the batched case
FAULT_N = 4096                   # per-sample state: 4096 values and a tag
MALI_FLATNESS = 1.05             # benchmarks/bench_mali_memory.py's gate


def _half_drift_checks(torch, seed: int):
    """K1 with MALI's half-drift row (0.5,) and one stage row at N =
    3,145,728 and K3 with it at (8, 393,218), f32 and bf16: bitwise their
    plain versions (K3's h = 0 row passing through); f32 times beside the
    byte bound, the plain version and ``torch.addcmul``. These launches
    compare: the caller resets the counts after."""
    from repro_torch.core.stepper import HALF_DRIFT
    from repro_torch.kernels import rk_stage
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    worst = {"rk_stage_increment": 0.0, "rk_stage_increment_batched": 0.0}
    times = {}
    n1 = math.prod(NODE18_SHAPE)
    for dtype in (torch.float32, torch.bfloat16):
        z = torch.randn(n1, generator=gen, device="cuda").to(dtype)
        v = torch.randn(1, n1, generator=gen, device="cuda").to(dtype)
        h = torch.full((), 0.0375, device="cuda")
        out = rk_stage.rk_stage_increment(z, v, h, HALF_DRIFT)
        ref = rk_stage.increment_plain(z, v, h, HALF_DRIFT)
        torch.cuda.synchronize()
        diff = float((out.float() - ref.float()).abs().max())
        worst["rk_stage_increment"] = max(worst["rk_stage_increment"], diff)
        check(torch.equal(out, ref), f"K1 half-drift n={n1} {dtype}: not "
              f"bitwise (max |diff| {diff})")
        if dtype == torch.float32:
            hw = 0.5 * h
            t = {"n": n1, "ms": time_ms(torch, lambda: rk_stage.
                                        rk_stage_increment(z, v, h,
                                                           HALF_DRIFT)),
                 "plain_ms": time_ms(torch, lambda: rk_stage.increment_plain(
                     z, v, h, HALF_DRIFT)),
                 "library_ms": time_ms(torch, lambda: torch.addcmul(
                     z, v[0], hw))}
            _bound(t, rk_stage.increment_work(1, n1, 1))
            times["k1_half_drift"] = t
        del z, v
    B, n = BATCH_ROWS, SERVE_ROW_N
    for dtype in (torch.float32, torch.bfloat16):
        z = torch.randn(B, n, generator=gen, device="cuda").to(dtype)
        v = torch.randn(1, B, n, generator=gen, device="cuda").to(dtype)
        h = torch.linspace(0.01, 0.08, B, device="cuda")
        h[B // 2] = 0.0                              # a frozen row
        out = rk_stage.rk_stage_increment_batched(z, v, h, HALF_DRIFT)
        ref = rk_stage.increment_batched_plain(z, v, h, HALF_DRIFT)
        torch.cuda.synchronize()
        diff = float((out.float() - ref.float()).abs().max())
        worst["rk_stage_increment_batched"] = max(
            worst["rk_stage_increment_batched"], diff)
        check(torch.equal(out, ref) and torch.equal(out[B // 2], z[B // 2]),
              f"K3 half-drift ({B}, {n}) {dtype}: not bitwise (max |diff| "
              f"{diff}) or the h = 0 row moved")
        if dtype == torch.float32:
            hw = (0.5 * h)[:, None]
            t = {"n": n, "rows": B,
                 "ms": time_ms(torch, lambda: rk_stage.
                               rk_stage_increment_batched(z, v, h,
                                                          HALF_DRIFT)),
                 "plain_ms": time_ms(torch, lambda: rk_stage.
                                     increment_batched_plain(z, v, h,
                                                             HALF_DRIFT)),
                 "library_ms": time_ms(torch, lambda: torch.addcmul(
                     z, v[0], hw))}
            _bound(t, rk_stage.increment_work(B, n, 1))
            times["k3_half_drift"] = t
        del z, v
    return worst, times


def _fault_problem(torch):
    """The fault-injection field on the fused path: a per-sample state of
    FAULT_N values and a tag, dx = tanh(w·x) − x/2 and a constant tag;
    NaN from t >= FAULT_T on, in every sample (``faulty``) or in the
    sample tagged FAULT_ROW (``faulty_row``)."""
    def field(t, z, w):
        x = z[:-1]
        return torch.cat([torch.tanh(w * x) - 0.5 * x, torch.zeros_like(
            z[-1:])])

    def poison(out, trig):
        return torch.where(trig, torch.full_like(out, float("nan")), out)

    def faulty(t, z, w):
        return poison(field(t, z, w), t >= FAULT_T)

    def faulty_row(t, z, w):
        hit = torch.abs(z[-1] - FAULT_ROW) < 0.5
        return poison(field(t, z, w), (t >= FAULT_T) & hit)

    return field, faulty, faulty_row


def _fault_injection(torch, seed: int):
    """NaN at t >= 0.5 on the fused path for aca, adjoint, naive and mali,
    solo and at B = 8 with one row faulted (see
    ``phase_solve_health_mali``); guard_nonfinite True against False on
    clean solves of the three engines; the lattice's integer adds wrap on
    CUDA int32 and int64. Returns the report."""
    import numpy as np

    from repro_torch.core import (ControllerConfig, SolveStatus,
                                  adaptive_while_solve,
                                  batched_adaptive_while_solve,
                                  mali_adaptive_solve, odeint)
    from repro_torch.core.stepper import lattice_add, lattice_sub
    from repro_torch.core.tableaus import DOPRI5

    field, faulty, faulty_row = _fault_problem(torch)
    rng = np.random.default_rng(seed + 23)
    x0 = rng.standard_normal((FAULT_ROWS, FAULT_N)).astype(np.float32)
    z0b = torch.from_numpy(np.concatenate(
        [x0, np.arange(FAULT_ROWS, dtype=np.float32)[:, None]], 1)).cuda()
    w = torch.tensor(0.9, device="cuda")
    ts = torch.linspace(0.0, 1.0, 5, device="cuda")
    n_pre = int((ts < FAULT_T).sum())
    report = {}
    for m in ("aca", "adjoint", "naive", "mali"):
        kw = dict(grad_method=m, rtol=1e-4, atol=1e-4, use_pallas=True,
                  solver=None if m == "mali" else "dopri5",
                  max_steps=1024 if m == "mali" else 256)
        # solo: the whole solve poisoned from t = 0.5
        z_ok, _ = odeint(field, z0b[0], ts, (w,), **kw)
        zg = z0b[0].clone().requires_grad_()
        ys, st = odeint(faulty, zg, ts, (w,), **kw)
        solo = {"status": int(st.status), "finite": bool(
            torch.isfinite(ys).all()), "prefix_bitwise": torch.equal(
                ys[:n_pre].detach(), z_ok[:n_pre])}
        if m != "naive":
            torch.sum(ys[-1] ** 2).backward()
            solo["grad_zero"] = bool((zg.grad == 0).all())
        check(solo["status"] == SolveStatus.NONFINITE_STATE
              and solo["finite"] and solo["prefix_bitwise"]
              and solo.get("grad_zero", True),
              f"fault injection {m} solo: {solo}")
        # batched: row FAULT_ROW poisoned, the others the clean batch's
        ys_ok, st_ok = odeint(field, z0b, ts, (w,), batch_axis=0, **kw)
        zg = z0b.clone().requires_grad_()
        ys, st = odeint(faulty_row, zg, ts, (w,), batch_axis=0, **kw)
        want = [SolveStatus.NONFINITE_STATE if b == FAULT_ROW else
                SolveStatus.OK for b in range(FAULT_ROWS)]
        others = [b for b in range(FAULT_ROWS) if b != FAULT_ROW]
        batched = {"status": st.status.tolist(),
                   "n_steps": st.n_steps.tolist(),
                   "finite": bool(torch.isfinite(ys).all()),
                   "others_bitwise": all(torch.equal(ys[:, b].detach(),
                                                     ys_ok[:, b])
                                         for b in others)}
        if m != "naive":
            torch.sum(ys[-1] ** 2).backward()
            batched["grads_finite"] = bool(torch.isfinite(zg.grad).all())
            batched["faulted_row_grad_zero"] = bool(
                (zg.grad[FAULT_ROW] == 0).all())
        check(batched["status"] == want and batched["finite"]
              and batched["others_bitwise"]
              and batched.get("grads_finite", True)
              and batched.get("faulted_row_grad_zero", True),
              f"fault injection {m} batched: {batched}")
        report[m] = {"solo": solo, "batched": batched}

    # the guards do nothing on a clean solve: True and False bitwise
    cfg = ControllerConfig(max_steps=256)
    guards = {}
    runs = [adaptive_while_solve(DOPRI5, field, z0b[0], ts, (w,), 1e-4,
                                 1e-4, cfg, use_pallas=True,
                                 guard_nonfinite=g)
            for g in (True, False)]
    guards["solo"] = torch.equal(runs[0][0], runs[1][0]) and int(
        runs[0][2].n_trials) == int(runs[1][2].n_trials)
    runs = [batched_adaptive_while_solve(DOPRI5, field, z0b, ts, (w,),
                                         1e-4, 1e-4, cfg, use_pallas=True,
                                         guard_nonfinite=g)
            for g in (True, False)]
    guards["batched"] = torch.equal(runs[0][0], runs[1][0]) and torch.equal(
        runs[0][2].n_trials, runs[1][2].n_trials)
    runs = [mali_adaptive_solve(field, z0b[0], ts, (w,), 1e-4, 1e-4,
                                ControllerConfig(max_steps=1024),
                                guard_nonfinite=g) for g in (True, False)]
    guards["mali"] = torch.equal(runs[0][0], runs[1][0]) and int(
        runs[0][2].n_trials) == int(runs[1][2].n_trials)
    check(all(guards.values()), f"guard_nonfinite changed a clean solve: "
          f"{guards}")

    wraps = {}
    for dt, bits in ((torch.int32, 32), (torch.int64, 64)):
        hi, lo = 2 ** (bits - 1) - 1, -2 ** (bits - 1)
        a = torch.tensor([hi, lo, 0], dtype=dt, device="cuda")
        b = torch.tensor([1, -1, hi], dtype=dt, device="cuda")
        wraps[str(dt)] = (lattice_add(a, b).tolist() == [lo, hi, hi]
                          and lattice_sub(a, b).tolist() == [hi - 1, lo + 1,
                                                             -hi]
                          and torch.equal(lattice_sub(lattice_add(a, b), b),
                                          a))
    check(all(wraps.values()), f"the lattice's adds do not wrap on CUDA: "
          f"{wraps}")
    return {"methods": report, "guards_bitwise": guards,
            "lattice_wraps": wraps}


def phase_solve_health_mali(torch, seed: int, aca_memory: dict):
    """Slices E and F on the card. (1) node18 at full width with
    ``NODE_TRAIN_MALI`` as published (ALF, rtol = atol = 1e-2, fused): one
    SGD step solo (the backward's half-drifts on K1) and one under
    batch_axis=0 (K3), the main path; one step each of ``NODE_TRAIN``
    (ACA, "auto") and of the full buffer from the same weights as the
    comparison; the backward's reconstructed start pair bitwise the
    encoded one, finite gradients, the plain route against the kernel
    route; K1 and K3 with the half-drift row bitwise their plain versions,
    timed. (2) MALI's peak memory on the method_costs field at 65,536 x 64
    at max_steps 64 and 512, flat within 5%, beside ACA's full buffer
    (``aca_memory``, from segmented_dense). (3) NaN at t >= 0.5 on the
    fused path for aca, adjoint, naive and mali, solo and at B = 8 with
    one row faulted. (4) ``failure_overhead`` in quick mode with its 5%
    gate."""
    import dataclasses
    import importlib

    import numpy as np

    from repro_torch.benchmarks import failure_overhead, method_costs
    from repro_torch.configs import node18_cifar
    from repro_torch.kernels import ops, rk_stage
    from repro_torch.models.config import RunConfig
    from repro_torch.models.transformer import (TransformerBlock, full_buffer,
                                                node_block)

    mali_mod = importlib.import_module("repro_torch.core.odeint_mali")
    worst, drift_times = _half_drift_checks(torch, seed)
    ops.reset_launches()

    # (1) node18 with NODE_TRAIN_MALI against NODE_TRAIN and the full buffer
    mali_cfg = node18_cifar.NODE_TRAIN_MALI
    rcfg = RunConfig(compute_dtype=torch.float32, node=mali_cfg)
    block = TransformerBlock(node18_cifar.CONFIG, rcfg, seed=seed,
                             device="cuda")
    init = {n: p.detach().clone() for n, p in block.named_parameters()}
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        NODE18_SHAPE).astype(np.float32)).cuda()
    opt = torch.optim.SGD(block.parameters(), lr=1e-2)
    starts = []
    orig_sweep = mali_mod.mali_backward_sweep

    def recording(sw):
        out = orig_sweep(sw)
        zq, vq = sw.encoded_start()
        starts.append(torch.equal(sw.zq, zq) and torch.equal(sw.vq, vq))
        return out

    mali_mod.mali_backward_sweep = recording
    kernels = ("rk_stage_increment", "rk_stage_increment_batched")

    def sgd_step(ncfg):
        with torch.no_grad():
            for n, p in block.named_parameters():
                p.copy_(init[n])
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        before = dict(rk_stage.launches)
        t0 = time.perf_counter()
        zT, st = node_block(block, x, ncfg)
        loss = torch.mean(zT ** 2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        grads = {n: p.grad.detach().clone()
                 for n, p in block.named_parameters()}
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        finite = bool(torch.isfinite(zT).all()) and all(
            bool(torch.isfinite(g).all()) for g in grads.values())
        check(finite, f"solve_health_mali node18 {ncfg.grad_method} "
              f"batch_axis={ncfg.batch_axis}: non-finite z(1) or gradients")
        check(not any(st.status.reshape(-1).tolist()),
              f"solve_health_mali node18: status {st.status.tolist()}")
        return {"zT": zT.detach(), "grads": grads,
                "n_steps": st.n_steps.tolist(),
                "n_trials": st.n_trials.tolist(), "nfe": st.nfe.tolist(),
                "forward_ms": 1e3 * (t1 - t0), "backward_ms": 1e3 * (t2 - t1),
                "step_ms": 1e3 * (t3 - t0),
                "peak_above_start_GB":
                (torch.cuda.max_memory_allocated() - base_mem) / 1e9,
                "launches": {k: rk_stage.launches[k] - before[k]
                             for k in kernels}}

    def summary(r):
        return {k: v for k, v in r.items() if k not in ("zT", "grads")}

    def grad_gap(ra, rb):
        return max(_rel(ra["grads"][n], rb["grads"][n]) for n in rb["grads"])

    batched_cfg = dataclasses.replace(mali_cfg, batch_axis=0)
    cfgs = {"mali_solo": mali_cfg, "mali_batched": batched_cfg,
            "aca_auto": node18_cifar.NODE_TRAIN,
            "aca_full": full_buffer(node18_cifar.NODE_TRAIN)}
    try:
        # an untimed first step each grows the allocator to its peak; the
        # two MALI ones check that the backward ends on the encoded start
        # pair (the timed steps below, from the same weights, run the
        # bare sweep)
        first_ms = {k: sgd_step(c)["step_ms"] for k, c in cfgs.items()}
    finally:
        mali_mod.mali_backward_sweep = orig_sweep
    check(starts == [True, True], "the MALI backward did not end on the "
          f"encoded start pair bit for bit: {starts}")
    torch.cuda.synchronize()
    ops.reset_launches()                   # the main path starts here
    runs = {k: sgd_step(cfgs[k]) for k in ("mali_solo", "mali_batched")}
    launches = {k: rk_stage.launches[k] for k in kernels}
    # the main path ends here
    check(launches["rk_stage_increment"] > 0
          and launches["rk_stage_increment_batched"] > 0,
          f"NODE_TRAIN_MALI did not launch K1 and K3: {launches}")
    runs.update({k: sgd_step(cfgs[k]) for k in ("aca_auto", "aca_full")})
    plain = {k: sgd_step(dataclasses.replace(cfgs[k], use_pallas=False))
             for k in ("mali_solo", "mali_batched")}
    route = {}
    for k, r in plain.items():
        route[k] = {"n_steps_equal": r["n_steps"] == runs[k]["n_steps"],
                    "z1_bitwise": torch.equal(r["zT"], runs[k]["zT"]),
                    "z1_rel": _rel(runs[k]["zT"], r["zT"]),
                    "grads_bitwise": all(torch.equal(runs[k]["grads"][n],
                                                     r["grads"][n])
                                         for n in r["grads"]),
                    "grad_rel": grad_gap(runs[k], r), "rtol": NODE_RTOL}
        check(route[k]["n_steps_equal"] and route[k]["z1_rel"] <= NODE_RTOL
              and route[k]["grad_rel"] <= NODE_RTOL,
              f"solve_health_mali {k}: the kernel route vs the plain route "
              f"{route[k]}")
    node18 = {k: summary(r) for k, r in runs.items()}
    vs_aca = {k: {"z1_rel": _rel(runs[k]["zT"], runs["aca_full"]["zT"]),
                  "grad_rel": grad_gap(runs[k], runs["aca_full"])}
              for k in ("mali_solo", "mali_batched")}
    for k, v in node18.items():
        emit({"phase": "solve_health_mali_node18", "config": k, **v})
    del runs, plain, block, opt, init

    # (2) memory where the state dominates: MALI flat in the step budget
    memory = {}
    for ms in (64, 512):
        memory[ms] = method_costs.peak_memory("mali", MEMORY_ROWS, ms,
                                              device="cuda")
        memory[ms]["aca_full_peak_bytes"] = aca_memory[ms]["full"][
            "peak_bytes"]
    flat = memory[512]["peak_bytes"] / memory[64]["peak_bytes"]
    check(flat <= MALI_FLATNESS, f"MALI's peak grew {flat:.4f}x from "
          f"max_steps 64 to 512 at 65,536 x 64 (gate {MALI_FLATNESS}x)")
    ops.reset_launches()

    # (3) fault injection on the fused path
    faults = _fault_injection(torch, seed)
    ops.reset_launches()

    # (4) the guards' cost gate in quick mode (raises when it fails)
    overhead = failure_overhead.run(quick=True, device="cuda")
    ops.reset_launches()

    emit({"phase": "solve_health_mali", "ok": True,
          "node18": {"shape": list(NODE18_SHAPE), "solver": mali_cfg.solver,
                     "rtol": mali_cfg.rtol, "atol": mali_cfg.atol,
                     "first_step_ms": first_ms, "start_pair_bitwise": True,
                     "kernel_vs_plain": route, "vs_aca_full": vs_aca},
          "memory_65536x64": {str(k): v for k, v in memory.items()},
          "mali_peak_growth": flat, "flatness_gate": MALI_FLATNESS,
          "fault_injection": faults, "failure_overhead": overhead,
          "half_drift_kernels": {"max_abs_err": worst,
                                 "timings": drift_times},
          "launches": launches})
    return launches, worst, drift_times


# ------------------------------------------------- the paper's benchmarks

def _check_paper_rows(bench: str, out: dict, rows: list) -> None:
    """One benchmark's rows: exactly the reference's names, all finite."""
    names = sorted(r.split(",")[0] for r in rows if not r.startswith("{"))
    want = sorted(PAPER_ROW_NAMES[bench])
    check(names == want and sorted(out) == want,
          f"{bench}: rows {names} != the reference's {want}")
    bad = {k: v for k, v in out.items() if not math.isfinite(v)}
    check(not bad, f"{bench}: non-finite rows {bad}")


def _within_factor(got: float, ref: float, factor: float,
                   floor: float) -> bool:
    return ref / factor - floor <= got <= factor * ref + floor


def phase_paper_benchmarks(torch):
    """The paper's training benchmarks (Fig. 4/5, Tables 1-7) on the card:
    each port benchmark's ``run`` in quick mode with the step counts of
    ``PAPER_CUTS`` (the main path; K1/K2 launch in method_costs'
    aca_pallas row), then the checks against the reference's numbers, ACA
    on K1/K2 against its plain path, and the peak memory of each method
    where the state outnumbers the parameters."""
    from repro_torch.benchmarks import (classification, common,
                                        method_costs, reliability,
                                        reverse_error, solver_robustness,
                                        threebody, timeseries)
    from repro_torch.kernels import ops, rk_stage

    mods = {"reverse_error": reverse_error, "method_costs": method_costs,
            "classification": classification, "reliability": reliability,
            "solver_robustness": solver_robustness,
            "timeseries": timeseries, "threebody": threebody}
    results, seconds = {}, {}
    torch.cuda.synchronize()
    ops.reset_launches()                   # the main path starts here
    for bench, mod in mods.items():
        common.ROWS.clear()
        t0 = time.perf_counter()
        out = mod.run(quick=True, device="cuda", **PAPER_CUTS[bench])
        torch.cuda.synchronize()
        seconds[bench] = time.perf_counter() - t0
        results[bench] = out
        emit({"phase": "paper_benchmark", "bench": bench,
              "seconds": seconds[bench], "cuts": PAPER_CUTS[bench],
              "rows": out})
        _check_paper_rows(bench, out, list(common.ROWS))
    launches = {k: rk_stage.launches[k] for k in K1_K2}  # ends here
    check(all(v > 0 for v in launches.values()),
          f"method_costs' aca_pallas did not launch K1 and K2: {launches}")

    checks = {}
    # Fig. 4/5: the reverse-time drift, within a factor of the reference's
    # (the grids follow each device's rounding) either way
    ref = PAPER_REFERENCE["reverse_error"]
    for name, r in ref.items():
        got = results["reverse_error"][name]
        checks[name] = {"port": got, "reference": r}
        check(_within_factor(got, r, REVERSE_FACTOR, REVERSE_FLOOR),
              f"{name}: {got} not within {REVERSE_FACTOR}x of the "
              f"reference's {r} (+ {REVERSE_FLOOR})")
    # Table 1: the accepted steps of every variant; trials and evaluations
    # of aca, adjoint and aca_pallas; the naive method's trials taken
    for label, _ in method_costs.VARIANTS:
        r = PAPER_REFERENCE["method_costs"][label]
        steps = results["method_costs"][f"table1_accepted_steps/{label}"]
        nfe = results["method_costs"][f"table1_nfe/{label}"]
        checks[f"method_costs/{label}"] = {"n_steps": [steps, r["n_steps"]],
                                           "nfe": [nfe, r["nfe"]]}
        check(steps == r["n_steps"],
              f"method_costs {label}: {steps} steps != {r['n_steps']}")
        if label == "naive":
            check(nfe < r["nfe"], f"naive nfe {nfe} not within the "
                  f"reference's budget x stages {r['nfe']}")
        else:
            check(nfe == r["nfe"],
                  f"method_costs {label}: nfe {nfe} != {r['nfe']}")
    # Table 5: the mass fit from log m = 0
    for gm in ("aca", "adjoint", "naive"):
        name = f"table5_ode_mse/{gm}"
        got, r = results["threebody"][name], PAPER_REFERENCE["threebody"][name]
        checks[name] = {"port": got, "reference": r}
        check(_within_factor(got, r, MASS_FIT_FACTOR, MASS_FIT_FLOOR),
              f"{name}: {got} not within {MASS_FIT_FACTOR}x of the "
              f"reference's {r} (+ {MASS_FIT_FLOOR})")
        unfitted = PAPER_REFERENCE["threebody"]["table5_ode_mse/unfitted"]
        check(got < unfitted, f"{name}: {got} is not below the unfitted "
              f"masses' MSE {unfitted}")
    # Table 2: the NODE learns (chance is 1/3 for three classes)
    for gm in ("aca", "adjoint", "naive"):
        acc = results["classification"][f"table2_test_acc/node_{gm}"]
        check(acc >= NODE_MIN_ACC,
              f"NODE {gm} test accuracy {acc} < {NODE_MIN_ACC}")

    # ACA on K1/K2 against its plain path on the card: the same trials in
    # the same order, so z(T) bitwise; the replay's K1 under autograd
    # differentiates through the plain version (gradients 1e-5)
    w1, w2, z0 = method_costs.init("cuda")
    ms = method_costs.SETTINGS[True]["max_steps"]
    _, g_k, z_k, st_k = method_costs.value_and_grad("aca_pallas", w1, w2,
                                                    z0, ms)
    _, g_p, z_p, st_p = method_costs.value_and_grad("aca", w1, w2, z0, ms)
    pallas = {"z_bitwise": bool(torch.equal(z_k, z_p)),
              "grad_rel": [_rel(a, b) for a, b in zip(g_k, g_p)],
              "n_steps": [int(st_k.n_steps), int(st_p.n_steps)]}
    check(pallas["z_bitwise"], "aca_pallas z(1) is not bitwise aca's")
    check(max(pallas["grad_rel"]) <= PALLAS_GRAD_RTOL,
          f"aca_pallas gradients {pallas['grad_rel']} > {PALLAS_GRAD_RTOL}")

    # peak memory where the state (65,536 x 64 = 4.19 M) outnumbers the
    # 8,192 parameters: ACA keeps a 64-slot buffer of the state
    memory = {label: method_costs.peak_memory(label, MEMORY_ROWS, 64,
                                              device="cuda")
              for label in ("aca", "adjoint", "naive")}
    memory["aca_buffer_bytes"] = 64 * MEMORY_ROWS * method_costs.D * 4
    emit({"phase": "paper_benchmarks", "ok": True, "seconds": seconds,
          "cuts": PAPER_CUTS, "checks": checks, "aca_pallas_vs_aca": pallas,
          "memory_65536x64": memory, "launches": launches,
          "bounds": {"reverse_factor": REVERSE_FACTOR,
                     "reverse_floor": REVERSE_FLOOR,
                     "mass_fit_factor": MASS_FIT_FACTOR,
                     "mass_fit_floor": MASS_FIT_FLOOR,
                     "node_min_acc": NODE_MIN_ACC,
                     "pallas_grad_rtol": PALLAS_GRAD_RTOL}})
    return launches


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _rows_rel(torch, a, b, rows: int = 16) -> float:
    """(..., S, d) tensors cut along S into tiles of ``rows`` rows (the
    last one short): max over tiles of ||a - b|| / ||b||."""
    def sq(x):
        x = torch.nn.functional.pad(x.flatten(0, -3), (0, 0, 0, -x.shape[-2]
                                                      % rows))
        return x.unflatten(1, (-1, rows)).square().sum((-1, -2))

    a, b = a.float(), b.float()
    return float((sq(a - b) / sq(b).clamp_min(1e-30)).sqrt().max())


def _bf16_ulps(torch, a, b) -> float:
    """max |a - b| in units of b's bf16 ulp (8 significant bits)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(b.abs())
    ulp = torch.ldexp(torch.ones_like(b), e - 8).clamp_min(2.0 ** -133)
    return float(((a - b).abs() / ulp).max())


def _bound(t: dict, work) -> dict:
    """``t`` with the bytes, FLOPs and bound of a kernel's ``work`` =
    (FLOPs by dtype, bytes), its kernel module's ``work`` formula, at
    ``launch/roofline.py``'s H100 rates."""
    from repro_torch.launch.roofline import kernel_bound

    flops, nbytes = work
    t["bytes"], t["flops"] = nbytes, sum(flops.values())
    t["bound_ms"], t["bound_by"] = kernel_bound(work)
    return t


def phase_kernels_lm(torch, seed: int):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rg_lru as lru
    from repro_torch.kernels import rmsnorm as k7
    from repro_torch.models.common import rmsnorm as rmsnorm_plain

    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    worst = {k: 0.0 for k in LM_KERNELS}
    cases = []

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    for rows in (16384, 16383, 4):
        for dtype in (torch.bfloat16, torch.float32):
            if rows == 4 and dtype == torch.float32:
                continue
            x = rnd(rows, 4096, scale=3.0).to(dtype)
            w = rnd(4096).to(dtype)
            ref = rmsnorm_plain(x, w)
            # the kernel K7's rule picks, then each of its two kernels
            for kernel in (None,) + k7.KERNELS:
                out = k7.rmsnorm(x, w, kernel=kernel)
                torch.cuda.synchronize()
                diff = float((out.float() - ref.float()).abs().max())
                worst["rmsnorm"] = max(worst["rmsnorm"], diff)
                if dtype == torch.float32:
                    err = _rel(out, ref)
                    ok = err <= RMS_F32_RTOL
                else:
                    err = _bf16_ulps(torch, out, ref)
                    ok = err <= RMS_BF16_ULPS
                cases.append({"kernel": "rmsnorm", "shape": [rows, 4096],
                              "dtype": str(dtype)[6:],
                              "k7_kernel": kernel or "rule", "err": err,
                              "max_abs_err": diff})
                check(ok, f"K7 ({rows}, 4096) {dtype} {kernel or 'rule'}: "
                      f"{err} beyond tolerance")
    for b, s, window in ((4, 4096, 2048), (4, 4096, 0), (2, 1000, 2048)):
        for dtype in (torch.bfloat16, torch.float32):
            q = rnd(b, 16, s, 256).to(dtype)
            k = rnd(b, 1, s, 256).to(dtype)
            v = rnd(b, 1, s, 256).to(dtype)
            out = ops.flash_attention(q, k, v, window=window)
            ref = fa.flash_attention_plain(q, k, v, window=window)
            torch.cuda.synchronize()
            diff = float((out.float() - ref.float()).abs().max())
            worst["flash_attention"] = max(worst["flash_attention"], diff)
            err = _rel(out, ref)
            tol = ATT_F32_RTOL if dtype == torch.float32 else ATT_BF16_RTOL
            rows_err = _rows_rel(torch, out, ref)
            rows_tol = math.inf if dtype == torch.float32 \
                else ATT_BF16_ROWS_RTOL
            cases.append({"kernel": "flash_attention",
                          "shape": [b, 16, s, 256], "kv_heads": 1,
                          "window": window, "dtype": str(dtype)[6:],
                          "err": err, "rows_err": rows_err,
                          "max_abs_err": diff})
            check(bool(torch.isfinite(out).all()) and err <= tol
                  and rows_err <= rows_tol,
                  f"K8 {(b, 16, s, 256)} window {window} {dtype}: {err} "
                  f"beyond {tol} or {rows_err} a 16-row tile beyond "
                  f"{rows_tol}")
            del q, k, v, out, ref
    # K8's second bf16 kernel (mma.sync, head dims 16 and 32: the SMOKE
    # configs'), by the wrapper's rule, at lengths and windows that are no
    # multiple of its 64 x 64 tiles; GQA with 2 kv heads
    for dh in (16, 32):
        for s, window in ((1000, 0), (1000, 100), (77, 7)):
            q = rnd(2, 4, s, dh).to(torch.bfloat16)
            k = rnd(2, 2, s, dh).to(torch.bfloat16)
            v = rnd(2, 2, s, dh).to(torch.bfloat16)
            ran = fa.variant_launches["mma_sync"]
            out = ops.flash_attention(q, k, v, window=window)
            ref = fa.flash_attention_plain(q, k, v, window=window)
            torch.cuda.synchronize()
            diff = float((out.float() - ref.float()).abs().max())
            worst["flash_attention"] = max(worst["flash_attention"], diff)
            err = _rel(out, ref)
            rows_err = _rows_rel(torch, out, ref)
            cases.append({"kernel": "flash_attention", "k8_kernel": "mma_sync",
                          "shape": [2, 4, s, dh], "kv_heads": 2,
                          "window": window, "dtype": "bfloat16",
                          "err": err, "rows_err": rows_err,
                          "max_abs_err": diff})
            check(fa.variant_launches["mma_sync"] == ran + 1
                  and bool(torch.isfinite(out).all())
                  and err <= ATT_BF16_RTOL
                  and rows_err <= ATT_BF16_ROWS_RTOL,
                  f"K8 mma_sync {(2, 4, s, dh)} window {window}: {err} "
                  f"beyond {ATT_BF16_RTOL}, {rows_err} a 16-row tile beyond "
                  f"{ATT_BF16_ROWS_RTOL} or not launched")
            del q, k, v, out, ref
    for b, s in ((4, 4096), (2, 1000)):
        log_a = -F.softplus(rnd(b, s, 4096))
        x = rnd(b, s, 4096)
        out = ops.rg_lru(log_a, x)
        ref = lru.rg_lru_plain(log_a, x)
        torch.cuda.synchronize()
        diff = float((out - ref).abs().max())
        worst["rg_lru"] = max(worst["rg_lru"], diff)
        err = _rel(out, ref)
        cases.append({"kernel": "rg_lru", "shape": [b, s, 4096],
                      "dtype": "float32", "err": err, "max_abs_err": diff})
        check(err <= LRU_RTOL, f"K10 ({b}, {s}, 4096): {err} > {LRU_RTOL}")
    lo, hi = LRU_WEAK_LOG_A
    log_a = lo + (hi - lo) * torch.rand(4, 4096, 4096, generator=gen,
                                        device="cuda")
    x = rnd(4, 4096, 4096)
    out = ops.rg_lru(log_a, x)
    ref = lru.rg_lru_plain(log_a, x)
    torch.cuda.synchronize()
    diff = float((out - ref).abs().max())
    worst["rg_lru"] = max(worst["rg_lru"], diff)
    err = _rel(out, ref)
    cases.append({"kernel": "rg_lru", "shape": [4, 4096, 4096],
                  "dtype": "float32", "log_a_range": list(LRU_WEAK_LOG_A),
                  "err": err, "max_abs_err": diff,
                  "bound": lru_weak_rtol(4096)})
    check(bool(torch.isfinite(out).all()) and err <= lru_weak_rtol(4096),
          f"K10 weak decay (4, 4096, 4096): {err} > {lru_weak_rtol(4096)}")
    del log_a, x, out, ref
    strong = ops.rg_lru(torch.full((1, 4096, 64), -2.0, device="cuda"),
                        torch.ones((1, 4096, 64), device="cuda"))
    fixed = 1.0 / (1.0 - math.exp(-2.0))
    check(bool(torch.isfinite(strong).all())
          and abs(float(strong[0, -1, 0]) - fixed) <= 1e-5 * fixed,
          "K10 strong decay: not the fixed point 1 / (1 - e^-2)")
    emit({"phase": "kernels_lm", "ok": True, "cases": cases,
          "max_abs_err": worst,
          "tolerances": {"rmsnorm_f32_rtol": RMS_F32_RTOL,
                         "rmsnorm_bf16_ulps": RMS_BF16_ULPS,
                         "attention_f32_rtol": ATT_F32_RTOL,
                         "attention_bf16_rtol": ATT_BF16_RTOL,
                         "attention_bf16_rows_rtol": ATT_BF16_ROWS_RTOL,
                         "rg_lru_rtol": LRU_RTOL,
                         "rg_lru_weak_rtol": lru_weak_rtol(4096)}})

    # times at the serving path's shapes and types (prefill of call A; K7
    # also at the decode rows of both LMs' widths); K7 through the kernel
    # its rule picks ("ms") and through each of its two kernels
    timings = {}
    # the launch floor: an empty kernel of one warp on the kernels' ctypes
    # route, timed as every kernel is; no kernel can take less. Taken here,
    # beside K7's decode rows, with the card's clocks up
    timings["launch_floor"] = {"ms": time_ms(
        torch, lambda: k7.noop("cuda"), iters=50, warmup=10)}
    for key, rows, d in (("rmsnorm", 16384, 4096),
                         ("rmsnorm_decode", 4, 4096),
                         ("rmsnorm_decode_2560", 4, 2560),
                         ("rmsnorm_decode_5120", 4, 5120)):
        x = rnd(rows, d).to(torch.bfloat16)
        w = rnd(d).to(torch.bfloat16)
        timings[key] = {
            "shape": [rows, d], "dtype": "bfloat16",
            "kernel": k7.kernel_for(d, 2, True),
            "ms": time_ms(torch, lambda: ops.rmsnorm(x, w)),
            **{f"{k}_ms": time_ms(torch, lambda k=k: k7.rmsnorm(
                x, w, kernel=k)) for k in k7.KERNELS},
            "plain_ms": time_ms(torch, lambda: rmsnorm_plain(x, w)),
            "library_ms": time_ms(torch, lambda: F.rms_norm(
                x, (d,), w, 1e-6)),
            "work": k7.work(rows, d, 2, 2)}
    del x, w
    b, s, window = 4, 4096, 2048
    q = rnd(b, 16, s, 256).to(torch.bfloat16)
    k = rnd(b, 1, s, 256).to(torch.bfloat16)
    v = rnd(b, 1, s, 256).to(torch.bfloat16)
    ke = k.expand(b, 16, s, 256).contiguous()
    ve = v.expand(b, 16, s, 256).contiguous()
    mask = fa.band_mask(s, window, device="cuda")
    timings["flash_attention"] = {
        "shape": [b, 16, s, 256], "kv_heads": 1, "window": window,
        "dtype": "bfloat16",
        "ms": time_ms(torch, lambda: ops.flash_attention(
            q, k, v, window=window), iters=10, warmup=2),
        "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, window=window), iters=5, warmup=1),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, ke, ve, attn_mask=mask), iters=10, warmup=2),
        "work": fa.work(b, 16, 1, s, 256, window, 2)}
    # window 0 (causal) beside SDPA's own causal path, which computes K8's
    # function there without a mask tensor
    timings["flash_attention_causal"] = {
        "shape": [b, 16, s, 256], "kv_heads": 1, "window": 0,
        "dtype": "bfloat16",
        "ms": time_ms(torch, lambda: ops.flash_attention(
            q, k, v, window=0), iters=10, warmup=2),
        "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, window=0), iters=5, warmup=1),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=True), iters=10, warmup=2),
        "work": fa.work(b, 16, 1, s, 256, 0, 2)}
    del q, k, v, ke, ve
    # the mma.sync kernel (head dim 32, off the main paths) causal at the
    # same length
    q = rnd(b, 16, s, 32).to(torch.bfloat16)
    k = rnd(b, 16, s, 32).to(torch.bfloat16)
    v = rnd(b, 16, s, 32).to(torch.bfloat16)
    timings["flash_attention_mma_sync"] = {
        "shape": [b, 16, s, 32], "kv_heads": 16, "window": 0,
        "dtype": "bfloat16", "kernel": fa.kernel_for(32, 2),
        "ms": time_ms(torch, lambda: ops.flash_attention(
            q, k, v, window=0), iters=10, warmup=2),
        "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, window=0), iters=5, warmup=1),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=10, warmup=2),
        "work": fa.work(b, 16, 16, s, 32, 0, 2)}
    del q, k, v
    # K10 at call A's and call B's prefill shapes
    for key, shape in (("rg_lru", (4, 4096, 4096)),
                       ("rg_lru_call_b", (2, 1000, 4096))):
        log_a = -F.softplus(rnd(*shape))
        x = rnd(*shape)
        timings[key] = {
            "shape": list(shape), "dtype": "float32",
            "ms": time_ms(torch, lambda: ops.rg_lru(log_a, x), iters=10,
                          warmup=2),
            "plain_ms": time_ms(torch, lambda: lru.rg_lru_plain(log_a, x),
                                iters=5, warmup=1),
            "library_ms": None,
            "work": lru.work(log_a.numel())}
        del log_a, x
    for key, t in timings.items():
        if key != "launch_floor":
            _bound(t, t.pop("work"))
    emit({"phase": "kernel_times_lm", "ok": True, "timings": timings})
    return worst, timings


def _cast_tree(tree, dtype):
    """Floating leaves to ``dtype``; RG-LRU's ``lam`` stays f32."""
    return {k: (_cast_tree(v, dtype) if isinstance(v, dict)
                else v if k == "lam" else v.to(dtype))
            for k, v in tree.items()}


def _margins(torch, model, params, toks, s, new):
    """The model's last-position logits along ``toks`` (B, s + new): the
    prefill's and each decode step's, teacher-forced; returns (top-2
    margins (B, new), max |logit|)."""
    margins, top = [], 0.0
    with torch.no_grad():
        lg, caches = model.prefill(params, {"tokens": toks[:, :s]})
        for j in range(new):
            top2 = torch.topk(lg.float(), 2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
            top = max(top, float(lg.float().abs().max()))
            if j + 1 < new:
                lg, caches = model.decode_step(
                    params, {"tokens": toks[:, s + j:s + j + 1]}, caches,
                    s + j)
    return torch.stack(margins, dim=1), top


def phase_serve_recurrentgemma(torch, seed: int):
    import dataclasses

    from repro_torch.configs import recurrentgemma_9b
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as k7
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = dataclasses.replace(recurrentgemma_9b.CONFIG, n_layers=RG_LAYERS)
    max_seq = max(s + n for _, s, n in RG_CALLS.values()) + 8
    run16 = RunConfig(compute_dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16, use_pallas=True,
                      max_seq=max_seq)
    model = build_model(cfg, run16)
    params = model.init(seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_params = model.n_params()
    tgen = torch.Generator(device="cuda").manual_seed(seed + 5)
    prompts = {name: torch.randint(0, cfg.vocab, (b, s), generator=tgen,
                                   device="cuda", dtype=torch.int32)
               for name, (b, s, _) in RG_CALLS.items()}
    # warm-up (cuBLAS handles, the kernels' first launch): not counted
    ServeEngine(model, params, ServeConfig(max_new_tokens=2)).generate(
        prompts["B"][:, :64])
    torch.cuda.synchronize()

    calls, outs, main_launches = {}, {}, {k: 0 for k in LM_KERNELS}
    for name, (b, s, new) in RG_CALLS.items():
        engine = ServeEngine(model, params, ServeConfig(max_new_tokens=new))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()               # the main path starts here
        t0 = time.perf_counter()
        out = engine.generate(prompts[name])["tokens"]
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = ops.launch_counts()       # the main path ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps = engine.last_decode_steps
        want = {"rmsnorm": (2 * RG_LAYERS + 1) * (1 + steps),
                "flash_attention": 1, "rg_lru": 4}
        got = {k: counts[k] for k in LM_KERNELS}
        check(got == want, f"call {name}: launches {got} != {want}")
        k7_kernels = dict(k7.variant_launches)
        check(sum(k7_kernels.values()) == got["rmsnorm"],
              f"call {name}: K7's kernels {k7_kernels} != {got['rmsnorm']}")
        k8_kernels = dict(fa.variant_launches)
        check(k8_kernels == _k8_wgmma(got["flash_attention"]),
              f"call {name}: K8's kernels {k8_kernels}")
        check(steps == new - 1, f"call {name}: {steps} decode steps")
        for k in LM_KERNELS:
            main_launches[k] += got[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.prefill(prompts[name])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        outs[name] = out
        calls[name] = {
            "prompts": b, "prompt_len": s, "new_tokens": new,
            "decode_steps": steps, "launches": got,
            "rmsnorm_kernels": k7_kernels,
            "flash_attention_kernels": k8_kernels,
            "generate_ms": 1e3 * gen_s, "prefill_ms": 1e3 * prefill_s,
            "decode_ms_per_token": 1e3 * (gen_s - prefill_s) / steps,
            "tokens_per_s": b * new / gen_s, "peak_mem_GB": peak,
            "finite_tokens": bool(((out >= 0) & (out < cfg.vocab)).all()),
        }
        check(tuple(out.shape) == (b, s + new)
              and calls[name]["finite_tokens"]
              and torch.equal(out[:, :s], prompts[name]),
              f"call {name}: output tokens {tuple(out.shape)} malformed")
        emit({"phase": "serve_call", "call": name, **calls[name]})

    # the plain route (use_pallas=False) on the same weights
    plain = build_model(cfg, dataclasses.replace(run16, use_pallas=False))
    routes = {}
    for name, (b, s, new) in RG_CALLS.items():
        with torch.no_grad():
            lk, _ = model.prefill(params, {"tokens": prompts[name]})
            lp, _ = plain.prefill(params, {"tokens": prompts[name]})
        out_p = ServeEngine(plain, params, ServeConfig(
            max_new_tokens=new)).generate(prompts[name])["tokens"]
        margins, top = _margins(torch, plain, params, out_p, s, new)
        tol = 2 * LOGIT_BF16_RTOL * top
        gen_k, gen_p = outs[name][:, s:], out_p[:, s:]
        equal, bad = 0, []
        for row in range(b):
            diff = (gen_k[row] != gen_p[row]).nonzero()
            first = int(diff[0]) if len(diff) else new
            equal += int((gen_k[row] == gen_p[row]).sum())
            if first < new and float(margins[row, first]) > tol:
                bad.append({"row": row, "step": first,
                            "margin": float(margins[row, first])})
        logit_err = _rel(lk, lp)
        routes[name] = {"prefill_logit_rel": logit_err,
                        "tokens_equal": equal, "tokens": b * new,
                        "max_logit": top, "margin_tol": tol,
                        "diverged_above_margin": bad}
        check(logit_err <= LOGIT_BF16_RTOL,
              f"call {name}: prefill logits kernels vs plain {logit_err} > "
              f"{LOGIT_BF16_RTOL}")
        check(not bad, f"call {name}: greedy tokens differ where the plain "
              f"route's margin exceeds the tolerance: {bad}")
    del params, model, plain
    torch.cuda.empty_cache()

    # one f32 prefill of both routes (TF32 off), the same seed's weights
    b, s, _ = RG_CALLS["A"]
    run32 = dataclasses.replace(run16, compute_dtype=torch.float32,
                                param_dtype=torch.float32)
    m32 = build_model(cfg, run32)
    p32 = m32.init(seed=seed, device="cuda")
    toks = prompts["A"][:1]
    with torch.no_grad():
        lk, _ = m32.prefill(p32, {"tokens": toks})
        lp, _ = build_model(cfg, dataclasses.replace(
            run32, use_pallas=False)).prefill(p32, {"tokens": toks})
    f32_err = _rel(lk, lp)
    del p32, m32
    torch.cuda.empty_cache()
    emit({"phase": "serve_recurrentgemma", "ok": True,
          "config": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                     "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                     "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
                     "vocab": cfg.vocab, "window": cfg.window,
                     "d_rnn": cfg.d_rnn, "n_params": n_params,
                     "dtype": "bfloat16", "max_seq": max_seq},
          "calls": calls, "kernels_vs_plain": routes,
          "logit_bf16_rtol": LOGIT_BF16_RTOL,
          "f32_prefill": {"prompts": 1, "prompt_len": s,
                          "logit_rel": f32_err,
                          "rtol": LOGIT_F32_RTOL},
          "launches": main_launches})
    check(f32_err <= LOGIT_F32_RTOL,
          f"f32 prefill kernels vs plain {f32_err} > {LOGIT_F32_RTOL}")
    return main_launches, calls


def _ssd_err(torch, y, yp) -> float:
    """max |y - yp| beyond one bf16 ulp of yp (bf16) or at all (f32),
    over max |yp|."""
    d = (y.float() - yp.float()).abs()
    if y.dtype == torch.bfloat16:
        _, e = torch.frexp(yp.float().abs())
        d = (d - torch.ldexp(torch.ones_like(d), e - 8)).clamp_min(0.0)
    return float(d.max() / yp.float().abs().max())


def _ssd_inputs(torch, gen, b, s, h, p, g, n, dtype, weak=False):
    """The Mamba-2 block's distributions at the reference init: x, B, C
    after SiLU-like scales, dt = softplus(N(0, 1)), a = -U[1, 16] (the
    uniform_ssm init). There a chunk of 256 steps decays by about e^-200,
    so the state carried between chunks adds nothing measurable. ``weak``
    draws long memory instead: dt log-uniform in [1e-3, 1e-2] (the low end
    of Mamba-2's dt init) and a = -exp(N(0, 1)) (the reference test's),
    so a chunk decays by about e^-1 and the carried state dominates y and
    h_last."""
    import math

    import torch.nn.functional as F
    x = (0.5 * torch.randn(b, s, h, p, generator=gen, device="cuda")).to(dtype)
    if weak:
        lo, hi = math.log(1e-3), math.log(1e-2)
        dt = torch.exp(lo + (hi - lo) * torch.rand(b, s, h, generator=gen,
                                                   device="cuda"))
        a = -torch.exp(torch.randn(h, generator=gen, device="cuda"))
    else:
        dt = F.softplus(torch.randn(b, s, h, generator=gen, device="cuda"))
        a = -(1.0 + 15.0 * torch.rand(h, generator=gen, device="cuda"))
    bm = (0.5 * torch.randn(b, s, g, n, generator=gen, device="cuda")).to(
        dtype)
    cm = (0.5 * torch.randn(b, s, g, n, generator=gen, device="cuda")).to(
        dtype)
    return x, dt, a, bm, cm


def phase_kernels_ssm(torch, seed: int):
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as k7
    from repro_torch.kernels import ssd_scan as k9
    from repro_torch.launch.roofline import HBM_BW
    from repro_torch.models.common import rmsnorm as rmsnorm_plain

    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    worst = {"ssd_scan": 0.0}
    cases = []
    # K9 at the mamba2_2_7b prefill shapes: 80 heads x 64, one group of
    # state 128, chunk 256; call A's (4, 4096) and call B's padded (2, 1024)
    # at the reference init, and call A's with weak decay, where the state
    # carried over 16 chunks dominates (the median chunk decay exp(sum of
    # dt a over the chunk) is reported and must exceed SSD_WEAK_DECAY)
    for b, s, weak in ((4, 4096, False), (2, 1024, False), (4, 4096, True)):
        for dtype in (torch.bfloat16, torch.float32):
            x, dt, a, bm, cm = _ssd_inputs(torch, gen, b, s, 80, 64, 1, 128,
                                           dtype, weak=weak)
            decay = float(torch.exp((dt * a).reshape(b, s // 256, 256, 80)
                                    .sum(2)).median())
            if weak:
                check(decay >= SSD_WEAK_DECAY,
                      f"K9 weak-decay inputs: median chunk decay {decay} "
                      f"< {SSD_WEAK_DECAY}")
            y, hl = ops.ssd_scan(x, dt, a, bm, cm, 256)
            yp, hp = k9.ssd_scan_plain(x, dt, a, bm, cm, 256)
            torch.cuda.synchronize()
            diff = float((y.float() - yp.float()).abs().max())
            worst["ssd_scan"] = max(worst["ssd_scan"], diff)
            err_y, err_h = _ssd_err(torch, y, yp), _rel(hl, hp)
            cases.append({"kernel": "ssd_scan", "shape": [b, s, 80, 64],
                          "state": 128, "groups": 1, "chunk": 256,
                          "dtype": str(dtype)[6:],
                          "decay": "weak" if weak else "reference init",
                          "median_chunk_decay": decay, "y_err": err_y,
                          "h_last_rel": err_h, "max_abs_err": diff})
            check(bool(torch.isfinite(y.float()).all())
                  and err_y <= SSD_F32_RTOL and err_h <= SSD_F32_RTOL,
                  f"K9 ({b}, {s}, 80, 64) {dtype} weak={weak}: y {err_y}, "
                  f"h_last {err_h} beyond {SSD_F32_RTOL}")
            del x, dt, a, bm, cm, y, hl, yp, hp
            torch.cuda.empty_cache()
    # K9's three bf16 kernels one at a time against their plain parts, on
    # the same inputs, at call A's shape (reference init and weak decay):
    # cs and S_c (chunk_states), h_prev and h_last (state_pass) as a share
    # of max |plain|, y (chunk_outputs) beyond one bf16 ulp
    for k in K9_PARTS:
        worst[k] = 0.0
    for weak in (False, True):
        x, dt, a, bm, cm = _ssd_inputs(torch, gen, 4, 4096, 80, 64, 1, 128,
                                       torch.bfloat16, weak=weak)
        cs_p, st_p = k9.chunk_states(x, dt, a, bm, 256)
        hp_p, hl_p = k9.state_pass(st_p, cs_p, 256)
        cs, st = k9.ssd_chunk_state(x, dt, a, bm, 256)
        got = {"ssd_chunk_state": ((cs, cs_p), (st, st_p))}
        hp, hl = k9.ssd_state_pass(st_p.clone(), cs_p, 256)
        got["ssd_state_pass"] = ((hp, hp_p), (hl, hl_p))
        y = k9.ssd_chunk_scan(x, dt, cs_p, bm, cm, hp_p, 256)
        got["ssd_chunk_scan"] = ((y, k9.chunk_outputs(
            x, dt, cs_p, bm, cm, hp_p, 256).to(x.dtype)),)
        torch.cuda.synchronize()
        for k, pairs in got.items():
            err = max(_ssd_err(torch, u, v) if u.dtype == torch.bfloat16
                      else _rel(u, v) for u, v in pairs)
            diff = max(float((u.float() - v.float()).abs().max())
                       for u, v in pairs)
            worst[k] = max(worst[k], diff)
            cases.append({"kernel": k, "shape": [4, 4096, 80, 64],
                          "state": 128, "groups": 1, "chunk": 256,
                          "dtype": "bfloat16",
                          "decay": "weak" if weak else "reference init",
                          "err": err, "max_abs_err": diff})
            check(err <= SSD_F32_RTOL and all(
                bool(torch.isfinite(u.float()).all()) for u, _ in pairs),
                f"{k} (4, 4096, 80, 64) weak={weak}: {err} beyond "
                f"{SSD_F32_RTOL}")
        del x, dt, a, bm, cm, cs_p, st_p, hp_p, hl_p, cs, st, hp, hl, y, got
        torch.cuda.empty_cache()
    # K7 at the Mamba-2 widths: the gated norm (5120) and the final norm
    # (2560), call A's prefill rows and the decode rows
    for d in (5120, 2560):
        for rows, dtype in ((16384, torch.bfloat16), (16384, torch.float32),
                            (4, torch.bfloat16)):
            x = (3.0 * torch.randn(rows, d, generator=gen, device="cuda")).to(
                dtype)
            w = torch.randn(d, generator=gen, device="cuda").to(dtype)
            ref = rmsnorm_plain(x, w)
            # the kernel K7's rule picks, then each of its two kernels
            for kernel in (None,) + k7.KERNELS:
                out = k7.rmsnorm(x, w, kernel=kernel)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    err = _rel(out, ref)
                    ok = err <= RMS_F32_RTOL
                else:
                    err = _bf16_ulps(torch, out, ref)
                    ok = err <= RMS_BF16_ULPS
                cases.append({"kernel": "rmsnorm", "shape": [rows, d],
                              "dtype": str(dtype)[6:],
                              "k7_kernel": kernel or "rule", "err": err})
                check(ok, f"K7 ({rows}, {d}) {dtype} {kernel or 'rule'}: "
                      f"{err} beyond tolerance")
    emit({"phase": "kernels_ssm", "ok": True, "cases": cases,
          "max_abs_err": worst, "ssd_f32_rtol": SSD_F32_RTOL})

    # times at call A's prefill shape and type
    b, s, h, p, n, q = 4, 4096, 80, 64, 128, 256
    x, dt, a, bm, cm = _ssd_inputs(torch, gen, b, s, h, p, 1, n,
                                   torch.bfloat16)
    timings = {"ssd_scan": {
        "shape": [b, s, h, p], "state": n, "chunk": q, "dtype": "bfloat16",
        "ms": time_ms(torch, lambda: ops.ssd_scan(x, dt, a, bm, cm, q),
                      iters=10, warmup=2),
        "plain_ms": time_ms(torch, lambda: k9.ssd_scan_plain(
            x, dt, a, bm, cm, q), iters=3, warmup=1),
        "library_ms": None,
        # x and y bf16, dt f32, B and C bf16, a, h_last f32; the causal
        # half of C B^T, its masked product with x, C h, the state update
        "work": k9.work(b, s, h, p, 1, n, q, 2)}}
    # the three kernels alone, each on the outputs of the one before it;
    # bytes each reads and writes once, and their sum: the design's floor
    cs, st = k9.ssd_chunk_state(x, dt, a, bm, q)
    saved = st.clone()
    k9.ssd_state_pass(st, cs, q)
    h_prev = st.clone()
    timings["ssd_chunk_state"] = {
        "ms": time_ms(torch, lambda: k9.ssd_chunk_state(x, dt, a, bm, q),
                      iters=10, warmup=2),
        "plain_ms": time_ms(torch, lambda: k9.chunk_states(
            x, dt, a, bm, q), iters=3, warmup=1),
        # x, B, dt, a in; cs and S_c out
        "work": k9.chunk_state_work(b, s, h, p, 1, n, q, 2)}
    timings["ssd_state_pass"] = {
        "ms": time_ms(torch, lambda: k9.ssd_state_pass(st, cs, q),
                      iters=10, warmup=2, prep=lambda: st.copy_(saved)),
        "plain_ms": time_ms(torch, lambda: k9.state_pass(saved, cs, q),
                            iters=3, warmup=1),
        # S_c in, h_prev out, the chunks' last cs, h_last
        "work": k9.state_pass_work(b, s // q, h, p, n)}
    timings["ssd_chunk_scan"] = {
        "ms": time_ms(torch, lambda: k9.ssd_chunk_scan(
            x, dt, cs, bm, cm, h_prev, q), iters=10, warmup=2),
        "plain_ms": time_ms(torch, lambda: k9.chunk_outputs(
            x, dt, cs, bm, cm, h_prev, q), iters=3, warmup=1),
        # x, dt, cs, B, C, h_prev in; y out
        "work": k9.chunk_scan_work(b, s, h, p, 1, n, q, 2)}
    for k in K9_PARTS:
        timings[k].update({"shape": [b, s, h, p], "state": n, "chunk": q,
                           "dtype": "bfloat16", "library_ms": None})
    del x, dt, a, bm, cm, cs, st, saved, h_prev
    xr = torch.randn(16384, 5120, generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.randn(5120, generator=gen, device="cuda").to(torch.bfloat16)
    timings["rmsnorm_5120"] = {
        "shape": [16384, 5120], "dtype": "bfloat16",
        "ms": time_ms(torch, lambda: ops.rmsnorm(xr, w)),
        "plain_ms": time_ms(torch, lambda: rmsnorm_plain(xr, w)),
        "library_ms": time_ms(torch, lambda: F.rms_norm(
            xr, (5120,), w, 1e-6)),
        "work": k7.work(16384, 5120, 2, 2)}
    del xr
    torch.cuda.empty_cache()
    for t in timings.values():
        _bound(t, t.pop("work"))
    k9t = timings["ssd_scan"]
    k9t["parts_ms"] = sum(timings[k]["ms"] for k in K9_PARTS)
    k9t["design_bytes"] = sum(timings[k]["bytes"] for k in K9_PARTS)
    k9t["design_floor_ms"] = 1e3 * k9t["design_bytes"] / HBM_BW
    emit({"phase": "kernel_times_ssm", "ok": True, "timings": timings})
    return worst, timings


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "ssd_scan" in n or any(k in n for k in K9_PARTS):
        return "ssd_scan"
    if "rmsnorm" in n:
        return "rmsnorm"
    # cuBLAS's Hopper GEMMs are named nvjet_*, older ones *gemm*/*xmma*
    if any(k in n for k in ("nvjet", "gemm", "xmma", "cutlass", "gemv")):
        return "matmul"
    return "other"


def _trace(torch, fn) -> dict:
    """One call of ``fn`` (after one untraced warm-up call) under
    torch.profiler: wall ms on the host clock to a synchronize, the
    device's busy ms (the sum of its kernels' times), kernels launched,
    the idle share 1 - busy / wall, device ms by class (matmul, K9, K7,
    other) and the six kernels with the most device time. The profiler
    adds host time per op, so the wall here is above an untraced one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, by_class = {}, {}
    for e in kern:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        cls = _kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + us
    busy_ms = 1e-3 * sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "kernels": len(kern),
            "idle_share": (1.0 - busy_ms / wall_ms) if kern else None,
            "device_ms_by_class": {k: 1e-3 * v for k, v in by_class.items()},
            "top": [[name[:80], 1e-3 * us] for name, us in top]}


def phase_serve_mamba2(torch, seed: int):
    import dataclasses

    from repro_torch.configs import mamba2_2_7b
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as k7
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = mamba2_2_7b.CONFIG
    layers = cfg.n_layers
    run16 = RunConfig(compute_dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16, use_pallas=True)
    model = build_model(cfg, run16)
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()   # earlier phases' tensors
    params = model.init(seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_params = model.n_params()
    tgen = torch.Generator(device="cuda").manual_seed(seed + 7)
    prompts = {name: torch.randint(0, cfg.vocab, (b, s), generator=tgen,
                                   device="cuda", dtype=torch.int32)
               for name, (b, s, _) in M2_CALLS.items()}
    # warm-up (cuBLAS handles, the kernels' first launch): not counted
    ServeEngine(model, params, ServeConfig(max_new_tokens=2)).generate(
        prompts["B"][:, :64])
    torch.cuda.synchronize()

    calls, outs, main_launches = {}, {}, {k: 0 for k in SSM_KERNELS}
    for name, (b, s, new) in M2_CALLS.items():
        engine = ServeEngine(model, params, ServeConfig(max_new_tokens=new))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()               # the main path starts here
        t0 = time.perf_counter()
        out = engine.generate(prompts[name])["tokens"]
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = ops.launch_counts()       # the main path ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps = engine.last_decode_steps
        want = {"rmsnorm": (2 * layers + 1) * (1 + steps),
                "ssd_scan": layers, **{k: layers for k in K9_PARTS}}
        got = {k: counts[k] for k in SSM_KERNELS}
        others = {k: v for k, v in counts.items()
                  if k not in SSM_KERNELS and v}
        check(got == want and not others,
              f"call {name}: launches {got} (others {others}) != {want}")
        k7_kernels = dict(k7.variant_launches)
        check(sum(k7_kernels.values()) == got["rmsnorm"],
              f"call {name}: K7's kernels {k7_kernels} != {got['rmsnorm']}")
        check(steps == new - 1, f"call {name}: {steps} decode steps")
        for k in SSM_KERNELS:
            main_launches[k] += got[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.prefill(prompts[name])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        outs[name] = out
        calls[name] = {
            "prompts": b, "prompt_len": s, "new_tokens": new,
            "decode_steps": steps, "launches": got,
            "rmsnorm_kernels": k7_kernels,
            "generate_ms": 1e3 * gen_s, "prefill_ms": 1e3 * prefill_s,
            "decode_ms_per_token": 1e3 * (gen_s - prefill_s) / steps,
            "tokens_per_s": b * new / gen_s, "peak_mem_GB": peak,
            "finite_tokens": bool(((out >= 0) & (out < cfg.vocab)).all()),
        }
        check(tuple(out.shape) == (b, s + new)
              and calls[name]["finite_tokens"]
              and torch.equal(out[:, :s], prompts[name]),
              f"call {name}: output tokens {tuple(out.shape)} malformed")
        emit({"phase": "serve_call", "model": "mamba2_2_7b", "call": name,
              **calls[name]})

    # where the time goes: one traced prefill of call A and one traced
    # decode step after call B's prefill (not main-path runs)
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": prompts["B"]})
        nxt = outs["B"][:, M2_CALLS["B"][1]:M2_CALLS["B"][1] + 1]
        traces = {
            "prefill_A": _trace(torch, lambda: model.prefill(
                params, {"tokens": prompts["A"]})),
            "decode_step_B": _trace(torch, lambda: model.decode_step(
                params, {"tokens": nxt}, caches, M2_CALLS["B"][1])),
        }
    del caches
    emit({"phase": "serve_mamba2_trace", "traces": traces})

    # the plain route (use_pallas=False) on the same weights
    plain = build_model(cfg, dataclasses.replace(run16, use_pallas=False))
    routes = {}
    for name, (b, s, new) in M2_CALLS.items():
        with torch.no_grad():
            lk = model.prefill(params, {"tokens": prompts[name]})[0]
            lp = plain.prefill(params, {"tokens": prompts[name]})[0]
        check(bool(torch.isfinite(lk.float()).all()),
              f"call {name}: prefill logits not finite")
        out_p = ServeEngine(plain, params, ServeConfig(
            max_new_tokens=new)).generate(prompts[name])["tokens"]
        margins, top = _margins(torch, plain, params, out_p, s, new)
        tol = 2 * M2_LOGIT_BF16_RTOL * top
        gen_k, gen_p = outs[name][:, s:], out_p[:, s:]
        equal, bad = 0, []
        for row in range(b):
            diff = (gen_k[row] != gen_p[row]).nonzero()
            first = int(diff[0]) if len(diff) else new
            equal += int((gen_k[row] == gen_p[row]).sum())
            if first < new and float(margins[row, first]) > tol:
                bad.append({"row": row, "step": first,
                            "margin": float(margins[row, first])})
        logit_err = _rel(lk, lp)
        routes[name] = {"prefill_logit_rel": logit_err,
                        "tokens_equal": equal, "tokens": b * new,
                        "max_logit": top, "margin_tol": tol,
                        "margins_above_tol": int((margins > tol).sum()),
                        "diverged_above_margin": bad,
                        "share_of_bound": logit_err / M2_LOGIT_BF16_RTOL}
        check(logit_err <= M2_LOGIT_BF16_RTOL,
              f"call {name}: prefill logits kernels vs plain {logit_err} > "
              f"{M2_LOGIT_BF16_RTOL}")
        check(not bad, f"call {name}: greedy tokens differ where the plain "
              f"route's margin exceeds the tolerance: {bad}")
    del plain
    _whole_call_cost(torch, "mamba2_2_7b", model, params, prompts["B"],
                     held_before)
    del params, model
    torch.cuda.empty_cache()

    # one f32 prefill of both routes on call B's prompts (TF32 off)
    run32 = dataclasses.replace(run16, compute_dtype=torch.float32,
                                param_dtype=torch.float32)
    m32 = build_model(cfg, run32)
    p32 = m32.init(seed=seed, device="cuda")
    ops.reset_launches()
    with torch.no_grad():
        lk, _ = m32.prefill(p32, {"tokens": prompts["B"]})
        f32_launches = ops.launch_counts()["ssd_scan"]
        lp, _ = build_model(cfg, dataclasses.replace(
            run32, use_pallas=False)).prefill(p32, {"tokens": prompts["B"]})
    f32_err = _rel(lk, lp)
    del p32, m32
    torch.cuda.empty_cache()
    emit({"phase": "serve_mamba2", "ok": True,
          "config": {"d_model": cfg.d_model, "n_layers": layers,
                     "d_inner": cfg.d_inner, "ssm_heads": cfg.ssm_heads,
                     "ssm_head_dim": cfg.ssm_head_dim,
                     "ssm_state": cfg.ssm_state,
                     "ssm_ngroups": cfg.ssm_ngroups,
                     "ssm_conv": cfg.ssm_conv, "ssm_chunk": cfg.ssm_chunk,
                     "vocab": cfg.vocab, "n_params": n_params,
                     "dtype": "bfloat16"},
          "calls": calls, "kernels_vs_plain": routes,
          "logit_bf16_rtol": M2_LOGIT_BF16_RTOL,
          "f32_prefill": {"prompts": M2_CALLS["B"][0],
                          "prompt_len": M2_CALLS["B"][1],
                          "logit_rel": f32_err, "rtol": LOGIT_F32_RTOL,
                          "ssd_scan_launches": f32_launches},
          "launches": main_launches})
    check(f32_launches == layers,
          f"f32 prefill: {f32_launches} K9 launches != {layers}")
    check(f32_err <= LOGIT_F32_RTOL,
          f"f32 prefill kernels vs plain {f32_err} > {LOGIT_F32_RTOL}")
    return main_launches, calls


# ---------------------------------------------------- dense and MoE serving

MOE_CALLS = {"A": (4, 4096, 32), "B": (2, 1000, 16)}  # prompts, length, new
MOE_F32_LAYERS = 4              # the f32 cut: full widths, 4 of 28 layers
MOE_KERNELS = ("rmsnorm", "flash_attention")
# bf16 kernel route against the plain route over the whole 28-layer MoE:
# K7's and K8's bf16 roundings flip 3.6% (call A) and 4.1% (call B) of
# the router's choices, from layer 0 on, and a flipped token moves by
# O(1); the last position's logits read 7.9e-3 and 8.3e-3 of max |logit|
# (seed 0, H100). The bound is three times the larger (ROADMAP queue 3,
# "MoE routing flips")
MOE_LOGIT_BF16_RTOL = 2.5e-2
MUSICGEN_CALL = (2, 1024, 16)   # prompts, frames, decode frames


class _RouteLog:
    """Wraps ``models.moe._route`` to keep each call's expert ids (each
    token's set, sorted): the routing of every layer of one forward, in
    layer order."""

    def __init__(self, moe_mod):
        self.mod, self.orig, self.ids = moe_mod, moe_mod._route, None

    def __enter__(self):
        self.ids = []

        def route(x, w, cfg):
            out = self.orig(x, w, cfg)
            self.ids.append(out[0].sort(dim=-1).values)
            return out

        self.mod._route = route
        return self

    def __exit__(self, *exc):
        self.mod._route = self.orig


def _flips(a, b) -> int:
    """(layer, token) pairs whose expert sets differ."""
    return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))


def _k8_wgmma(n: int) -> dict:
    """K8's launches by kernel when all n took the wgmma kernel, as every
    bf16 main path does (head dims 64, 128 and 256)."""
    return {"wgmma": n, "mma_sync": 0, "f32": 0}


def _k8_case(torch, gen, b, h, s, dh, hkv=None):
    """K8 against its plain version at (b, h, s, dh) with ``hkv`` kv heads
    (default h), causal, bf16; times beside SDPA's causal call (on k and
    v expanded to h heads beforehand, untimed) and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    hkv = h if hkv is None else hkv
    q, k, v = (torch.randn(b, n, s, dh, generator=gen, device="cuda").to(
        torch.bfloat16) for n in (h, hkv, hkv))
    out = ops.flash_attention(q, k, v, window=0)
    ref = fa.flash_attention_plain(q, k, v, window=0)
    torch.cuda.synchronize()
    err = _rel(out, ref)
    rows_err = _rows_rel(torch, out, ref)
    diff = float((out.float() - ref.float()).abs().max())
    check(bool(torch.isfinite(out).all()) and err <= ATT_BF16_RTOL
          and rows_err <= ATT_BF16_ROWS_RTOL,
          f"K8 {(b, h, s, dh)} kv {hkv} causal bf16: {err} beyond "
          f"{ATT_BF16_RTOL} or {rows_err} a 16-row tile beyond "
          f"{ATT_BF16_ROWS_RTOL}")
    t = {"shape": [b, h, s, dh], "kv_heads": hkv, "window": 0,
         "dtype": "bfloat16", "kernel": fa.kernel_for(dh, 2), "err": err,
         "rows_err": rows_err, "max_abs_err": diff,
         "ms": time_ms(torch, lambda: ops.flash_attention(q, k, v, window=0),
                       iters=10, warmup=2),
         "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
             q, k, v, window=0), iters=5, warmup=1)}
    ke, ve = (x.repeat_interleave(h // hkv, dim=1) for x in (k, v))
    t["library_ms"] = time_ms(
        torch, lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                      is_causal=True),
        iters=10, warmup=2)
    return _bound(t, fa.work(b, h, hkv, s, dh, 0, 2))


def phase_serve_moe(torch, seed: int):
    import dataclasses

    from repro_torch.configs import deepseek_moe_16b, musicgen_medium
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as k7
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = deepseek_moe_16b.CONFIG
    layers = cfg.n_layers
    max_seq = max(s + n for _, s, n in MOE_CALLS.values()) + 8
    run16 = RunConfig(compute_dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16, use_pallas=True,
                      max_seq=max_seq)
    model = build_model(cfg, run16)
    n_params = model.n_params()
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()   # earlier phases' tensors
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # drawn leaf by leaf in f32 and cast: one f32 temporary at a time
    params = model.init(seed=seed, device="cuda")
    torch.cuda.synchronize()
    init = {"s": time.perf_counter() - t0,
            "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
            "params_GB": torch.cuda.memory_allocated() / 1e9}
    tgen = torch.Generator(device="cuda").manual_seed(seed + 7)
    prompts = {name: torch.randint(0, cfg.vocab, (b, s), generator=tgen,
                                   device="cuda", dtype=torch.int32)
               for name, (b, s, _) in MOE_CALLS.items()}
    # warm-up (cuBLAS handles, the kernels' first launch): not counted
    ServeEngine(model, params, ServeConfig(max_new_tokens=2)).generate(
        prompts["B"][:, :64])
    torch.cuda.synchronize()

    calls, main_launches = {}, {k: 0 for k in MOE_KERNELS}
    for name, (b, s, new) in MOE_CALLS.items():
        engine = ServeEngine(model, params, ServeConfig(max_new_tokens=new))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()               # the main path starts here
        t0 = time.perf_counter()
        out = engine.generate(prompts[name])["tokens"]
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = ops.launch_counts()       # the main path ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps = engine.last_decode_steps
        want = {"rmsnorm": (2 * layers + 1) * (1 + steps),
                "flash_attention": layers}
        got = {k: counts[k] for k in MOE_KERNELS}
        others = {k: v for k, v in counts.items()
                  if k not in MOE_KERNELS and v}
        check(got == want and not others,
              f"call {name}: launches {got} (others {others}) != {want}")
        k7_kernels = dict(k7.variant_launches)
        check(sum(k7_kernels.values()) == got["rmsnorm"],
              f"call {name}: K7's kernels {k7_kernels} != {got['rmsnorm']}")
        k8_kernels = dict(fa.variant_launches)
        check(k8_kernels == _k8_wgmma(got["flash_attention"]),
              f"call {name}: K8's kernels {k8_kernels}")
        check(steps == new - 1, f"call {name}: {steps} decode steps")
        for k in MOE_KERNELS:
            main_launches[k] += got[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.prefill(prompts[name])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        calls[name] = {
            "prompts": b, "prompt_len": s, "new_tokens": new,
            "capacity": moe_mod._capacity(b * s, cfg),
            "decode_capacity": moe_mod._capacity(b, cfg),
            "decode_steps": steps, "launches": got,
            "rmsnorm_kernels": k7_kernels,
            "flash_attention_kernels": k8_kernels,
            "generate_ms": 1e3 * gen_s, "prefill_ms": 1e3 * prefill_s,
            "decode_ms_per_token": 1e3 * (gen_s - prefill_s) / steps,
            "tokens_per_s": b * new / gen_s, "peak_mem_GB": peak,
            "finite_tokens": bool(((out >= 0) & (out < cfg.vocab)).all()),
        }
        check(tuple(out.shape) == (b, s + new)
              and calls[name]["finite_tokens"]
              and torch.equal(out[:, :s], prompts[name]),
              f"call {name}: output tokens {tuple(out.shape)} malformed")
        emit({"phase": "serve_call", "model": "deepseek_moe_16b",
              "call": name, **calls[name]})
    del engine, out

    # a repeated decode gives the same bits (the combine sums each token's
    # experts in a fixed order; no atomics)
    b, s, _ = MOE_CALLS["B"]
    with torch.no_grad():
        last, caches = model.prefill(params, {"tokens": prompts["B"]})
        nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        runs = []
        for _ in range(2):
            c = {k: {n: t.clone() for n, t in v.items()}
                 for k, v in caches.items()}
            lg = model.decode_step(params, {"tokens": nxt}, c, s)[0]
            lg2 = model.decode_step(params, {"tokens": nxt}, c, s + 1)[0]
            runs.append((lg, lg2))
        del caches, c
    repeat_bitwise = all(torch.equal(x, y) for x, y in zip(*runs))
    check(repeat_bitwise, "a repeated MoE decode is not bitwise equal")

    # the plain route (use_pallas=False) on the same weights: prefill
    # logits and the router's choices of every layer
    plain = build_model(cfg, dataclasses.replace(run16, use_pallas=False))
    routes = {}
    for name, (b, s, new) in MOE_CALLS.items():
        with torch.no_grad(), _RouteLog(moe_mod) as rk:
            lk = model.prefill(params, {"tokens": prompts[name]})[0]
        with torch.no_grad(), _RouteLog(moe_mod) as rp:
            lp = plain.prefill(params, {"tokens": prompts[name]})[0]
        check(bool(torch.isfinite(lk.float()).all()),
              f"call {name}: prefill logits not finite")
        flips = [_flips([x], [y]) for x, y in zip(rk.ids, rp.ids)]
        err = _rel(lk, lp)
        routes[name] = {"prefill_logit_rel": err,
                        "routing_flips": sum(flips),
                        "routing_flips_by_layer": flips,
                        "routing_choices": layers * b * s,
                        "first_flip_layer": next(
                            (i for i, f in enumerate(flips) if f), None),
                        "argmax_equal": int((lk.argmax(-1)
                                             == lp.argmax(-1)).sum()),
                        "share_of_bound": err / MOE_LOGIT_BF16_RTOL}
        check(err <= MOE_LOGIT_BF16_RTOL,
              f"call {name}: prefill logits kernels vs plain {err} > "
              f"{MOE_LOGIT_BF16_RTOL}")
    del plain
    _whole_call_cost(torch, "deepseek_moe_16b", model, params,
                     prompts["B"], held_before)
    del params, model
    torch.cuda.empty_cache()

    # f32 at full widths, 4 of the 28 layers (the f32 weights of all 28
    # would take 67.6 GB): the two routes to 1e-3 of max |logit|
    cut = dataclasses.replace(cfg, n_layers=MOE_F32_LAYERS)
    run32 = dataclasses.replace(run16, compute_dtype=torch.float32,
                                param_dtype=torch.float32)
    m32 = build_model(cut, run32)
    p32 = m32.init(seed=seed, device="cuda")
    f32 = {}
    for name in MOE_CALLS:
        ops.reset_launches()
        with torch.no_grad(), _RouteLog(moe_mod) as rk:
            lk, _ = m32.prefill(p32, {"tokens": prompts[name]})
        n_att = ops.launch_counts()["flash_attention"]
        with torch.no_grad(), _RouteLog(moe_mod) as rp:
            lp, _ = build_model(cut, dataclasses.replace(
                run32, use_pallas=False)).prefill(
                    p32, {"tokens": prompts[name]})
        f32[name] = {"logit_rel": _rel(lk, lp),
                     "routing_flips": _flips(rk.ids, rp.ids),
                     "flash_attention_launches": n_att}
        check(n_att == MOE_F32_LAYERS,
              f"f32 cut call {name}: {n_att} K8 launches")
        check(f32[name]["logit_rel"] <= LOGIT_F32_RTOL,
              f"f32 cut call {name}: kernels vs plain "
              f"{f32[name]['logit_rel']} > {LOGIT_F32_RTOL}")
    del p32, m32
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    k8 = {"head_dim_128": _k8_case(torch, gen, 4, 16, 4096, 128),
          "head_dim_64": _k8_case(torch, gen, 2, 24, 1024, 64)}
    emit({"phase": "kernel_times_moe", "ok": True, "flash_attention": k8})

    # musicgen_medium whole: the audio frontend's embeds, LayerNorm (no
    # K7), K8 at head dim 64 in every layer of the prefill
    mcfg = musicgen_medium.CONFIG
    mb, ms, mnew = MUSICGEN_CALL
    mrun = dataclasses.replace(run16, max_seq=ms + mnew + 8)
    mm = build_model(mcfg, mrun)
    mp = mm.init(seed=seed, device="cuda")
    emb = (0.02 * torch.randn(mb, ms + mnew, mcfg.d_model, generator=gen,
                              device="cuda")).to(torch.bfloat16)
    with torch.no_grad():
        mm.prefill(mp, {"embeds": emb[:, :64]})          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()               # the main path starts here
        t0 = time.perf_counter()
        last, caches = mm.prefill(mp, {"embeds": emb[:, :ms]})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frames = []
        for j in range(mnew):
            lg, caches = mm.decode_step(
                mp, {"embeds": emb[:, ms + j:ms + j + 1]}, caches, ms + j)
            frames.append(lg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        mcounts = ops.launch_counts()      # the main path ends here
        mk8 = dict(fa.variant_launches)
        mpeak = torch.cuda.max_memory_allocated() / 1e9
        lp, _ = build_model(mcfg, dataclasses.replace(
            mrun, use_pallas=False)).prefill(mp, {"embeds": emb[:, :ms]})
    mgot = {k: mcounts[k] for k in MOE_KERNELS}
    check(mgot == {"rmsnorm": 0, "flash_attention": mcfg.n_layers},
          f"musicgen: launches {mgot}")
    check(mk8 == _k8_wgmma(mcfg.n_layers), f"musicgen: K8's kernels {mk8}")
    check(all(bool(torch.isfinite(x.float()).all())
              for x in [last] + frames), "musicgen: logits not finite")
    music = {"n_params": mm.n_params(), "prompts": mb, "frames": ms,
             "decode_frames": mnew, "launches": mgot,
             "flash_attention_kernels": mk8,
             "prefill_ms": 1e3 * (t1 - t0),
             "decode_ms_per_frame": 1e3 * (t2 - t1) / mnew,
             "peak_mem_GB": mpeak,
             "prefill_logit_rel_plain": _rel(last, lp)}
    check(music["prefill_logit_rel_plain"] <= LOGIT_BF16_RTOL,
          f"musicgen: prefill logits kernels vs plain "
          f"{music['prefill_logit_rel_plain']} > {LOGIT_BF16_RTOL}")
    main_launches["flash_attention"] += mgot["flash_attention"]
    del mp, mm, caches
    torch.cuda.empty_cache()
    emit({"phase": "serve_moe", "ok": True,
          "config": {"d_model": cfg.d_model, "n_layers": layers,
                     "n_heads": cfg.n_heads, "head_dim":
                     cfg.resolved_head_dim, "n_experts": cfg.n_experts,
                     "n_shared_experts": cfg.n_shared_experts,
                     "top_k": cfg.top_k, "d_expert": cfg.d_expert,
                     "capacity_factor": cfg.capacity_factor,
                     "vocab": cfg.vocab, "n_params": n_params,
                     "dtype": "bfloat16", "max_seq": max_seq},
          "init": init, "calls": calls,
          "repeat_decode_bitwise": repeat_bitwise,
          "kernels_vs_plain": routes,
          "logit_bf16_rtol": MOE_LOGIT_BF16_RTOL,
          "f32_cut": {"n_layers": MOE_F32_LAYERS, "calls": f32,
                      "rtol": LOGIT_F32_RTOL},
          "musicgen": music, "launches": main_launches})
    return main_launches, calls, k8


# ------------------------------------- dense and MoE LMs on layer cuts

DENSE_ARCHS = ("qwen1_5_32b", "qwen2_72b", "command_r_35b",
               "command_r_plus_104b", "llava_next_34b",
               "qwen3_moe_235b_a22b")
DENSE_LAYERS = 4                # the bf16 cut: published widths, 4 layers
DENSE_F32_LAYERS = 2            # the f32 cut, on call B
DENSE_CALLS = {"A": (4, 4096, 32), "B": (2, 1000, 16)}  # prompts, length, new
# the plain route's prefill takes the dense configs' prompts this many at
# a time (each row is its own function there): its f32 (rows, H, S, S)
# scores at call A are 6.4 GB a row at command-r-plus's 96 heads, and all
# four rows beside its weights ran out of the H100's 80 GB. The MoE's
# capacity couples its rows: it takes each call whole
DENSE_PLAIN_ROWS = 2
# bf16 kernel route against the plain route: the last prefill position's
# logits, max |difference| over max |logit|, per config: three times the
# larger of the gaps of calls A and B (seed 0, H100), rounded up to two
# digits, as MOE_LOGIT_BF16_RTOL was derived. Measured (A, B): qwen1.5
# 6.88e-3, 7.28e-3; qwen2 6.85e-3, 7.46e-3; llava 8.06e-3, 6.17e-3;
# qwen3-moe 4.78e-3, 4.48e-3 (2.3% and 2.3% of the router's choices
# flipped, from layer 0 on). The Command-Rs' LayerNorm has no kernel, so
# K8 alone moves their logits: 3.79e-4, 1.89e-4 and 2.53e-4, 2.56e-4
DENSE_LOGIT_BF16_RTOL = {
    "qwen1_5_32b": 2.2e-2,
    "qwen2_72b": 2.3e-2,
    "command_r_35b": 1.2e-3,
    "command_r_plus_104b": 7.7e-4,
    "llava_next_34b": 2.5e-2,
    "qwen3_moe_235b_a22b": 1.5e-2,
}


def _k7_case(torch, gen, rows, d):
    """K7 (the kernel its rule picks) against its plain version at (rows,
    d), bf16, to one bf16 ulp; times beside ``F.rms_norm`` and the
    bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as k7
    from repro_torch.models.common import rmsnorm as rmsnorm_plain
    x = (3.0 * torch.randn(rows, d, generator=gen, device="cuda")).to(
        torch.bfloat16)
    w = torch.randn(d, generator=gen, device="cuda").to(torch.bfloat16)
    out = ops.rmsnorm(x, w)
    ref = rmsnorm_plain(x, w)
    torch.cuda.synchronize()
    err = _bf16_ulps(torch, out, ref)
    check(err <= RMS_BF16_ULPS, f"K7 ({rows}, {d}) bf16: {err} ulps")
    t = {"shape": [rows, d], "dtype": "bfloat16",
         "kernel": k7.kernel_for(d, 2, True), "err_ulps": err,
         "max_abs_err": float((out.float() - ref.float()).abs().max()),
         "ms": time_ms(torch, lambda: ops.rmsnorm(x, w)),
         "plain_ms": time_ms(torch, lambda: rmsnorm_plain(x, w)),
         "library_ms": time_ms(torch, lambda: F.rms_norm(x, (d,), w,
                                                          1e-6))}
    return _bound(t, k7.work(rows, d, 2, 2))


def _serve_dense(torch, seed: int, arch: str):
    """One config of ``phase_serve_dense_lms``: returns (main-path
    launches, calls, K8's case at call A's shape, K7's at call A's
    prefill rows or None)."""
    import dataclasses
    import importlib

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as k7
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServeEngine

    t_start = time.perf_counter()
    published = importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
    cfg = dataclasses.replace(published, n_layers=DENSE_LAYERS)
    layers, moe = cfg.n_layers, cfg.family == "moe"
    key = "tokens" if cfg.frontend == "none" else "embeds"
    bound = DENSE_LOGIT_BF16_RTOL[arch]
    max_seq = max(s + n for _, s, n in DENSE_CALLS.values()) + 8
    run16 = RunConfig(compute_dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16, use_pallas=True,
                      max_seq=max_seq)
    model = build_model(cfg, run16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=seed, device="cuda")
    torch.cuda.synchronize()
    init = {"s": time.perf_counter() - t0,
            "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
            "params_GB": torch.cuda.memory_allocated() / 1e9}
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    # token ids, or for llava's VLM stub N(0, 0.02^2) embeddings of every
    # position the call feeds (the prompt and each decode step's)
    inputs = {name: torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                  device="cuda", dtype=torch.int32)
              if key == "tokens" else (0.02 * torch.randn(
                  b, s + new, cfg.d_model, generator=gen,
                  device="cuda")).to(torch.bfloat16)
              for name, (b, s, new) in DENSE_CALLS.items()}

    def generate(x, s, new):
        """Greedy: (the new tokens (B, new), decode steps) after a
        prefill of x's first s positions. Token archs go through
        ``ServeEngine.generate``; llava's stub has no embedding table to
        feed a sampled token back, so it runs the engine's loop on
        ``Model.prefill`` / ``decode_step`` with the given embeds, each
        step's token the argmax of its logits."""
        if key == "tokens":
            engine = ServeEngine(model, params,
                                 ServeConfig(max_new_tokens=new))
            out = engine.generate(x[:, :s])["tokens"]
            check(tuple(out.shape) == (x.shape[0], s + new)
                  and torch.equal(out[:, :s], x[:, :s]),
                  f"{arch}: generate's output {tuple(out.shape)} malformed")
            return out[:, s:], engine.last_decode_steps
        with torch.no_grad():
            lg, caches = model.prefill(params, {key: x[:, :s]})
            toks = [torch.argmax(lg, dim=-1)]
            for j in range(new - 1):
                lg, caches = model.decode_step(
                    params, {key: x[:, s + j:s + j + 1]}, caches, s + j)
                toks.append(torch.argmax(lg, dim=-1))
        return torch.stack(toks, dim=1).to(torch.int32), new - 1

    # warm-up (cuBLAS handles, the kernels' first launch): not counted
    generate(inputs["B"], min(64, DENSE_CALLS["B"][1]), 2)
    torch.cuda.synchronize()

    fails, calls = [], {}
    launches = {k: 0 for k in MOE_KERNELS}
    for name, (b, s, new) in DENSE_CALLS.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()               # the main path starts here
        t0 = time.perf_counter()
        out, steps = generate(inputs[name], s, new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = ops.launch_counts()       # the main path ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        # K7: 2 norms a layer + the final one, in the prefill and in each
        # decode step (Command-R's LayerNorm has no kernel); K8: once a
        # layer in the prefill (decode stays plain)
        want = {"rmsnorm": (2 * layers + 1) * (1 + steps)
                if cfg.norm == "rmsnorm" else 0, "flash_attention": layers}
        got = {k: counts[k] for k in MOE_KERNELS}
        others = {k: v for k, v in counts.items()
                  if k not in MOE_KERNELS and v}
        k7_kernels = dict(k7.variant_launches)
        k8_kernels = dict(fa.variant_launches)
        for k in MOE_KERNELS:
            launches[k] += got[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model.prefill(params, {key: inputs[name][:, :s]})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        calls[name] = {
            "prompts": b, "prompt_len": s, "new_tokens": new,
            "decode_steps": steps, "launches": got, "want": want,
            "rmsnorm_kernels": k7_kernels,
            "flash_attention_kernels": k8_kernels,
            "generate_ms": 1e3 * gen_s, "prefill_ms": 1e3 * prefill_s,
            "decode_ms_per_token": 1e3 * (gen_s - prefill_s) / steps,
            "tokens_per_s": b * new / gen_s, "peak_mem_GB": peak,
            "tokens_in_vocab": bool(((out >= 0) & (out < cfg.vocab)).all())}
        if moe:
            calls[name]["capacity"] = moe_mod._capacity(b * s, cfg)
        if got != want or others:
            fails.append(f"call {name}: launches {got} (others {others}) "
                         f"!= {want}")
        if sum(k7_kernels.values()) != got["rmsnorm"]:
            fails.append(f"call {name}: K7's kernels {k7_kernels} != "
                         f"{got['rmsnorm']}")
        if k8_kernels != _k8_wgmma(got["flash_attention"]):
            fails.append(f"call {name}: K8's kernels {k8_kernels}")
        if steps != new - 1 or tuple(out.shape) != (b, new) \
                or not calls[name]["tokens_in_vocab"]:
            fails.append(f"call {name}: {steps} decode steps, tokens "
                         f"{tuple(out.shape)} malformed")
    del out

    # the plain route (use_pallas=False) on the same weights: the last
    # prefill position's logits and, for the MoE, the router's choices
    plain = build_model(cfg, dataclasses.replace(run16, use_pallas=False))
    routes = {}
    for name, (b, s, new) in DENSE_CALLS.items():
        batch = {key: inputs[name][:, :s]}
        with torch.no_grad(), _RouteLog(moe_mod) as rk:
            lk = model.prefill(params, batch)[0]
        with torch.no_grad(), _RouteLog(moe_mod) as rp:
            lp = plain.prefill(params, batch)[0] if moe else torch.cat([
                plain.prefill(params, {key: inputs[name][
                    i:i + DENSE_PLAIN_ROWS, :s]})[0]
                for i in range(0, b, DENSE_PLAIN_ROWS)])
        err = _rel(lk, lp)
        routes[name] = {"prefill_logit_rel": err,
                        "max_logit": float(lp.float().abs().max()),
                        "argmax_equal": int((lk.argmax(-1)
                                             == lp.argmax(-1)).sum()),
                        "rows": b}
        if moe:
            flips = [_flips([x], [y]) for x, y in zip(rk.ids, rp.ids)]
            routes[name].update(
                routing_flips=sum(flips), routing_flips_by_layer=flips,
                routing_choices=layers * b * s,
                routing_flip_share=sum(flips) / (layers * b * s))
        routes[name]["share_of_bound"] = err / bound
        if not bool(torch.isfinite(lk.float()).all()):
            fails.append(f"call {name}: prefill logits not finite")
        if not err <= bound:
            fails.append(f"call {name}: prefill logits kernels vs plain "
                         f"{err} > {bound}")
        del lk, lp
    n_params = model.n_params()
    del plain, params, model
    torch.cuda.empty_cache()

    # f32 at full widths on a 2-layer cut, call B: the two routes to 1e-3
    # of max |logit| (at call A the plain route's f32 (B, H, S, S) scores
    # alone take 17-26 GB a tensor)
    cut = dataclasses.replace(cfg, n_layers=DENSE_F32_LAYERS)
    run32 = dataclasses.replace(run16, compute_dtype=torch.float32,
                                param_dtype=torch.float32)
    m32 = build_model(cut, run32)
    p32 = m32.init(seed=seed, device="cuda")
    b, s, _ = DENSE_CALLS["B"]
    batch = {key: inputs["B"][:, :s]}
    ops.reset_launches()
    with torch.no_grad(), _RouteLog(moe_mod) as rk:
        lk = m32.prefill(p32, batch)[0]
    n_att = ops.launch_counts()["flash_attention"]
    with torch.no_grad(), _RouteLog(moe_mod) as rp:
        lp = build_model(cut, dataclasses.replace(
            run32, use_pallas=False)).prefill(p32, batch)[0]
    f32 = {"n_layers": DENSE_F32_LAYERS, "call": "B",
           "logit_rel": _rel(lk, lp), "rtol": LOGIT_F32_RTOL,
           "flash_attention_launches": n_att}
    if moe:
        f32["routing_flips"] = _flips(rk.ids, rp.ids)
        f32["routing_flip_share"] = f32["routing_flips"] / (
            DENSE_F32_LAYERS * b * s)
    if n_att != DENSE_F32_LAYERS:
        fails.append(f"f32 cut: {n_att} K8 launches")
    if not f32["logit_rel"] <= LOGIT_F32_RTOL:
        fails.append(f"f32 cut: kernels vs plain {f32['logit_rel']} > "
                     f"{LOGIT_F32_RTOL}")
    del p32, m32, lk, lp
    torch.cuda.empty_cache()

    # K8 alone at this config's head layout and call A's length
    b, s, _ = DENSE_CALLS["A"]
    k8 = _k8_case(torch, gen, b, cfg.n_heads, s, cfg.resolved_head_dim,
                  cfg.n_kv_heads)
    # and K7 at its prefill rows and width
    k7_case = _k7_case(torch, gen, b * s, cfg.d_model) \
        if cfg.norm == "rmsnorm" else None
    torch.cuda.empty_cache()
    emit({"phase": "serve_dense_lm", "model": arch, "ok": not fails,
          "config": {"name": cfg.name, "n_layers": layers,
                     "published_n_layers": published.n_layers,
                     "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                     "n_kv_heads": cfg.n_kv_heads,
                     "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                     "vocab": cfg.vocab, "norm": cfg.norm,
                     "qkv_bias": cfg.qkv_bias,
                     "parallel_block": cfg.parallel_block,
                     "tie_embeddings": cfg.tie_embeddings,
                     "frontend": cfg.frontend, "n_experts": cfg.n_experts,
                     "top_k": cfg.top_k, "d_expert": cfg.d_expert,
                     "capacity_factor": cfg.capacity_factor,
                     "n_params": n_params, "dtype": "bfloat16",
                     "max_seq": max_seq},
          "init": init, "calls": calls, "kernels_vs_plain": routes,
          "logit_bf16_rtol": bound, "f32_cut": f32, "flash_attention": k8,
          "rmsnorm": k7_case, "launches": launches, "seconds": time.perf_counter() - t_start,
          "fails": fails})
    check(not fails, f"{arch}: " + "; ".join(fails))
    return launches, calls, k8, k7_case


def phase_serve_dense_lms(torch, seed: int):
    """The six configs of DENSE_ARCHS one after another (the module
    docstring's 11b2); returns (main-path launches, calls, K8's cases,
    K7's cases) by config."""
    t0 = time.perf_counter()
    launches, calls, k8, k7_cases = {k: 0 for k in MOE_KERNELS}, {}, {}, {}
    for arch in DENSE_ARCHS:
        got, arch_calls, k8[arch], k7_case = _serve_dense(torch, seed, arch)
        if k7_case is not None:
            k7_cases[arch] = k7_case
        for k in MOE_KERNELS:
            launches[k] += got[k]
        calls.update({f"{arch}/{name}": c for name, c in arch_calls.items()})
    emit({"phase": "serve_dense_lms", "ok": True, "archs": list(DENSE_ARCHS),
          "n_layers": DENSE_LAYERS, "f32_n_layers": DENSE_F32_LAYERS,
          "launches": launches, "seconds": time.perf_counter() - t0})
    return launches, calls, k8, k7_cases


# ------------------------------------------ LM training with NODE blocks

NODE_LM_STEPS = (4, 6)          # checkpoint and resume at 4, stop at 6
NODE_LM_BATCH = (8, 128)        # global batch, sequence length
NODE_LM_GRAD_RTOL = 1e-5


def _tree_rel(torch, a, b) -> float:
    """Worst max |a - b| / max |b| over the leaves of two trees."""
    from torch.utils import _pytree as pytree
    worst = 0.0
    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        worst = max(worst, _rel(x, y) if bool((y != 0).any())
                    else float((x.float() - y.float()).abs().max()))
    return worst


def phase_train_node_lm(torch, seed: int):
    import dataclasses
    import shutil
    import tempfile

    from torch.utils import _pytree as pytree

    from repro_torch.configs import node18_cifar
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.optim import adamw, apply_updates, cosine_warmup
    from repro_torch.train import (TrainLoop, TrainLoopConfig,
                                   make_train_state)

    cfg = node18_cifar.CONFIG
    ncfg = node18_cifar.NODE_TRAIN
    rcfg = RunConfig(compute_dtype=torch.float32, node=ncfg)
    model = build_model(cfg, rcfg)
    gb, seq = NODE_LM_BATCH
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=gb,
                         seed=seed, device="cuda")
    opt = adamw(cosine_warmup(3e-4, 20, 300), weight_decay=0.1)
    ckpt_at, stop = NODE_LM_STEPS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_node_lm_")
    try:
        lcfg = TrainLoopConfig(clip_norm=1.0, ckpt_dir=tmp,
                               ckpt_every=ckpt_at, log_every=1)
        stragglers = []
        loop = TrainLoop(model, opt, lcfg,
                         make_train_state(model, opt, seed=seed,
                                          device="cuda"),
                         straggler_cb=lambda s, r: stragglers.append(
                             [s, r]))
        check(loop.step == 0, f"a fresh ckpt dir resumed at {loop.step}")
        steps, logs = [], {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()               # the main path starts here
        for s in range(stop):
            model.node_stats = []
            before = ops.launch_counts()
            t0 = time.perf_counter()
            loop.run(pipe.batch, s + 1,
                     log_cb=lambda i, m: logs.__setitem__(i, m))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = ops.launch_counts()
            st = model.node_stats
            steps.append({
                "step": s, "ms": 1e3 * dt, "loss": logs[s + 1]["loss"],
                "grad_norm": logs[s + 1]["grad_norm"],
                "skipped": logs[s + 1]["skipped"],
                "launches": {k: after[k] - before[k] for k in K1_K2},
                "block_steps": [int(x.n_steps) for _, _, x in st],
                "block_trials": [int(x.n_trials) for _, _, x in st]})
            if s + 1 == ckpt_at:
                saved = pytree.tree_map(lambda t: t.clone(),
                                        loop.state.params)
        counts = ops.launch_counts()       # the main path ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        model.node_stats = None
        launches = {k: counts[k] for k in K1_K2}
        others = {k: v for k, v in counts.items() if k not in K1_K2 and v}
        check(not others, f"train_node_lm: other kernels launched {others}")
        check(all(v > 0 for v in launches.values()),
              f"train_node_lm: launches {launches}")
        check(loop.skipped_steps == 0 and all(
            x["skipped"] == 0 for x in steps),
            f"train_node_lm: {loop.skipped_steps} skipped steps")
        check(all(math.isfinite(x["loss"]) for x in steps),
              "train_node_lm: non-finite loss")
        check(all(len(x["block_steps"]) == cfg.n_layers for x in steps),
              "train_node_lm: not one NODE solve per block")

        # a fresh loop resumes at the checkpoint bit for bit, and its
        # steps to the end give the uninterrupted run's parameters
        loop2 = TrainLoop(model, opt, lcfg,
                          make_train_state(model, opt, seed=seed + 1,
                                           device="cuda"))
        check(loop2.step == ckpt_at,
              f"resume: step {loop2.step} != {ckpt_at}")
        resume_bitwise = all(torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves(loop2.state.params),
            pytree.tree_leaves(saved)))
        check(resume_bitwise, "resume: params not bitwise the saved ones")
        loop2.run(pipe.batch, stop)
        resumed_rel = _tree_rel(torch, loop2.state.params,
                                loop.state.params)
        check(resumed_rel <= 1e-5,
              f"resumed run {resumed_rel} from the uninterrupted one")

        # the plain route (use_pallas=False: K1/K2's plain versions) on the
        # same state and batch: the loss bit for bit, gradients 1e-5
        # (each route's forward and backward, and one AdamW update, timed)
        batch = pipe.batch(stop)
        grads, split = {}, {}
        route_launches = {}
        for up in (True, False):
            m = build_model(cfg, dataclasses.replace(
                rcfg, node=dataclasses.replace(ncfg, use_pallas=up)))
            leaves, spec = pytree.tree_flatten(loop.state.params)
            live = [p.detach().requires_grad_(True) for p in leaves]
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = m.loss_fn(pytree.tree_unflatten(live, spec), batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            g = torch.autograd.grad(loss, live)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            route_launches[up] = {k: ops.launch_counts()[k] for k in K1_K2}
            grads[up] = (loss.detach(), g)
            split["kernels" if up else "plain"] = {
                "forward_ms": 1e3 * (t1 - t0), "backward_ms": 1e3 * (t2 - t1)}
        t0 = time.perf_counter()
        upd, _ = opt.update(pytree.tree_unflatten(list(grads[True][1]), spec),
                            loop.state.opt_state, loop.state.params)
        apply_updates(loop.state.params, upd)
        torch.cuda.synchronize()
        split["adamw_update_ms"] = 1e3 * (time.perf_counter() - t0)
        del upd
        loss_bitwise = torch.equal(grads[True][0], grads[False][0])
        grad_rel = max(_rel(a, b) for a, b in zip(grads[True][1],
                                                  grads[False][1])
                       if bool((b != 0).any()))
        check(loss_bitwise, f"kernel route loss {float(grads[True][0])} != "
              f"plain {float(grads[False][0])}")
        check(grad_rel <= NODE_LM_GRAD_RTOL,
              f"kernel vs plain gradients {grad_rel} > {NODE_LM_GRAD_RTOL}")
        check(all(v == 0 for v in route_launches[False].values())
              and all(v > 0 for v in route_launches[True].values()),
              f"route launches {route_launches}")
        del grads
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "train_node_lm", "ok": True,
          "config": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                     "n_heads": cfg.n_heads, "d_ff": cfg.d_ff,
                     "vocab": cfg.vocab, "n_params": model.n_params(),
                     "dtype": "float32", "batch": gb, "seq_len": seq,
                     "node": {"solver": ncfg.solver, "rtol": ncfg.rtol,
                              "grad_method": ncfg.grad_method,
                              "checkpoint_segments":
                              ncfg.checkpoint_segments}},
          "steps": steps, "step_split": split, "peak_mem_GB": peak,
          "launches": launches,
          "skipped_steps": loop.skipped_steps, "stragglers": stragglers,
          "resume_bitwise": resume_bitwise, "resumed_vs_uninterrupted":
          resumed_rel, "plain_route": {"loss_bitwise": loss_bitwise,
                                       "grad_rel": grad_rel,
                                       "launches": {str(k): v for k, v in
                                                    route_launches.items()}}})
    return launches, steps


# -------------------------------------------------------------------- main

# ------------------------------------------------ slices H and J (PR 25)

SERVE_METHODS = ("aca", "adjoint", "naive", "mali")
# the mixed-dtype node18 step's check against CPU tensors runs at this cut
# width (batch, sequence cut; d_model 768 as published)
MIXED_CUT = (2, 16, 768)
BF16_EPS = 2.0 ** -8            # one bf16 rounding, relative


def _round_ms(ms) -> dict:
    from repro_torch.benchmarks.common import percentile
    return {"rounds": len(ms), "mean_ms": sum(ms) / max(len(ms), 1),
            "p50_ms": percentile(ms, 50.0) if ms else None,
            "max_ms": max(ms) if ms else None}


def phase_serve_node_bench(torch, seed: int):
    """(a) ``benchmarks.serve_node`` in quick mode on the card with every
    round on K3/K5 and its four gates; (b) its trace under each gradient
    method; (c) the serve_node18 trace served continuously and static at
    node18 width. Returns the K3/K5 launches of (a) and (c)."""
    import numpy as np

    from repro_torch.benchmarks import serve_node
    from repro_torch.benchmarks.common import latency_summary
    from repro_torch.core import SolveStatus
    from repro_torch.kernels import ops, rk_stage

    t_phase = time.perf_counter()
    total = {k: 0 for k in SERVE_KERNELS}
    torch.cuda.synchronize()
    ops.reset_launches()                   # the main path starts here
    out = serve_node.run(quick=True, device="cuda", use_pallas=True)
    bench_launches = dict(rk_stage.launches)   # the main path ends here
    check(all(bench_launches[k] > 0 for k in SERVE_KERNELS),
          f"serve_node: the rounds did not launch K3 and K5: "
          f"{bench_launches}")
    for k in SERVE_KERNELS:
        total[k] += bench_launches[k]
    host = out["host"]
    emit({"phase": "serve_node_bench_quick", "ok": True,
          "rows": {k: v for k, v in out.items() if "/" in k},
          "continuous": {**_round_ms(host["continuous_round_ms"]),
                         "drain_s": host["continuous_drain_s"]},
          "static": {**_round_ms(host["static_round_ms"]),
                     "drain_s": host["static_drain_s"]},
          "launches": {k: bench_launches[k] for k in SERVE_KERNELS}})

    trace = serve_node.traffic(np.random.default_rng(0), 24)
    methods, finals = {}, {}
    for m in SERVE_METHODS:
        eng, res, ms, drain = serve_node.serve(trace, False, "cuda", True, m)
        finals[m] = res
        methods[m] = {"status": [r.status for r in res],
                      "n_trials": [r.n_trials for r in res],
                      "sim_clock": eng.clock.now, "drain_s": drain,
                      **_round_ms(ms)}
    aca = finals["aca"]
    same = {m: all(np.array_equal(a.z_final, b.z_final)
                   and a.n_trials == b.n_trials
                   for a, b in zip(finals[m], aca))
            for m in ("adjoint", "naive")}
    overflow = [r.req_id for r in finals["mali"]
                if r.status == SolveStatus.CHECKPOINT_OVERFLOW]
    emit({"phase": "serve_node_bench_methods", "ok": True,
          "methods": methods, "bitwise_aca": same,
          "mali_checkpoint_overflow": overflow,
          "mali_overflow_tols": [trace[i][1].rtol for i in overflow]})
    for m in ("aca", "adjoint", "naive"):
        check(all(r.ok for r in finals[m]),
              f"serve_node {m}: requests not OK: {methods[m]['status']}")
    check(all(same.values()),
          f"serve_node: adjoint/naive z_final or trials not ACA's: {same}")
    check(all(r.ok or r.status == SolveStatus.CHECKPOINT_OVERFLOW
              for r in finals["mali"]),
          f"serve_node mali: statuses {methods['mali']['status']}")

    # in turns (continuous, static, static, continuous), so that the
    # first run's warm-up is in neither mode's second run
    modes = {"continuous": [], "static": []}
    for static in (False, True, True, False):
        engine, reqs, _, _, _ = _node18_serving(torch, seed, static)
        label = "static" if static else "continuous"
        rounds, wall_s, launches = _serve_rounds(
            torch, engine, f"serve_node18_{label}_round")
        results = [engine.results[i] for i in sorted(engine.results)]
        check(len(results) == SERVE_REQUESTS and all(r.ok for r in results),
              f"serve_node18 {label}: {[r.status for r in results]}")
        check(all(launches[k] > 0 for k in SERVE_KERNELS),
              f"serve_node18 {label}: K3/K5 not launched: {launches}")
        for k in SERVE_KERNELS:
            total[k] += launches[k]
        lat = latency_summary([r.latency for r in results])
        modes[label].append({
            "sim_p50": lat["p50"], "sim_p99": lat["p99"],
            "sim_clock": engine.clock.now,
            "throughput_req_per_sim_t": SERVE_REQUESTS / engine.clock.now,
            **_round_ms([r["wall_ms"] for r in rounds]),
            "drain_s": wall_s,
            "launches": {k: launches[k] for k in SERVE_KERNELS},
            "mean_live": sum(engine.occupancy_log)
            / max(1, len(engine.occupancy_log))})
    cont, stat = modes["continuous"][1], modes["static"][0]
    modes["p99_ratio_sim"] = stat["sim_p99"] / cont["sim_p99"]
    # the second continuous run against the first static one: both after
    # a warm run
    modes["drain_ratio_wall"] = stat["drain_s"] / cont["drain_s"]
    emit({"phase": "serve_node_bench", "ok": True,
          "node18": modes, "seconds": time.perf_counter() - t_phase})
    return total


def phase_batched_solve(torch):
    """``benchmarks.batched_solve`` at its full size on the card: the three
    strategies' seconds, sample-evals and step spread; its gates (a spread
    of per-sample steps, per_sample's steps vmap_solo's)."""
    from repro_torch.benchmarks import batched_solve

    t0 = time.perf_counter()
    out = batched_solve.run(quick=False, device="cuda")
    emit({"phase": "batched_solve", "ok": True, "batch": 32, "dim": 64,
          "rows": {k: v for k, v in out.items() if "/" in k},
          "n_steps": out["n_steps"], "seconds": time.perf_counter() - t0})


def _mixed_field(block):
    """The node18 block's residual branch on the bf16 state "x", and "e":
    each sample's mean |f|^2 in f32 (as a CNF's f32 log-density or kinetic
    term rides beside a low-precision state)."""
    from repro_torch.models.transformer import branch_fn

    def fn(p, z, t):
        fx = branch_fn(block, p, z["x"]).to(z["x"].dtype)
        e = (fx.float() ** 2).mean(dim=tuple(range(1, fx.dim())))
        return {"x": fx, "e": e}

    return fn


def _mixed_configs():
    import dataclasses

    from repro_torch.configs import node18_cifar
    train = node18_cifar.NODE_TRAIN
    plain = dataclasses.replace(train, checkpoint_segments=None)
    return {"aca": train,
            "adjoint": dataclasses.replace(plain, grad_method="adjoint"),
            "naive": dataclasses.replace(plain, grad_method="naive"),
            "mali": node18_cifar.NODE_TRAIN_MALI}


def _mixed_block(torch, seed: int, shape, device):
    import numpy as np

    from repro_torch.configs import node18_cifar
    from repro_torch.models.config import RunConfig
    from repro_torch.models.transformer import TransformerBlock

    block = TransformerBlock(node18_cifar.CONFIG,
                             RunConfig(compute_dtype=torch.bfloat16),
                             seed=seed, device=device)
    x = torch.from_numpy(np.random.default_rng(seed + 5).standard_normal(
        shape).astype(np.float32)).to(device).to(torch.bfloat16)
    return block, x


def _sync(torch, device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _mixed_step(torch, block, x, ncfg, lr: float = 1e-2):
    """One SGD step of the block on {"x": bf16 x, "e": 0}: z(1), the
    gradients, the stats, forward and backward ms."""
    from repro_torch.core.node_block import node_block_solve

    params = dict(block.named_parameters())
    dev = x.device
    z0 = {"x": x, "e": torch.zeros(x.shape[0], device=dev)}
    _sync(torch, dev)
    t0 = time.perf_counter()
    zT, st = node_block_solve(_mixed_field(block), params, z0, ncfg)
    _sync(torch, dev)
    t1 = time.perf_counter()
    loss = torch.mean(zT["x"].float() ** 2) + torch.mean(zT["e"])
    grads = torch.autograd.grad(loss, list(params.values()))
    _sync(torch, dev)
    t2 = time.perf_counter()
    with torch.no_grad():
        for p, g in zip(params.values(), grads):
            p.sub_(lr * g)
    return {"x": zT["x"].detach(), "e": zT["e"].detach(),
            "loss": float(loss.detach()),
            "grads": dict(zip(params, grads)), "stats": st,
            "fwd_ms": 1e3 * (t1 - t0), "bwd_ms": 1e3 * (t2 - t1)}


def _field_drift(torch, seed: int):
    """One evaluation of the mixed field and of its parameter pullback at
    MIXED_CUT on the card and on CPU tensors, same weights and inputs:
    (the field's max |card - cpu| / max |cpu|, the pullback's)."""
    out = {}
    for dev in ("cuda", "cpu"):
        block, x = _mixed_block(torch, seed, MIXED_CUT, dev)
        params = dict(block.named_parameters())
        z = {"x": x, "e": torch.zeros(x.shape[0], device=dev)}
        f = _mixed_field(block)(params, z, None)
        g = torch.autograd.grad(torch.sum(f["x"].float() ** 2),
                                list(params.values()))
        out[dev] = (f["x"].detach().float().cpu(), [t.cpu() for t in g])

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    (fc, gc), (fh, gh) = out["cuda"], out["cpu"]
    return rel(fc, fh), max(rel(a, b) for a, b in zip(gc, gh))


def phase_mixed_dtype(torch, seed: int):
    """Slice J. The node18 block at full width on the state {"x": bf16 (8,
    512, 768), "e": f32 (8,)}: one SGD step per gradient method from the
    same weights (NODE_TRAIN's settings, NODE_TRAIN_MALI's for mali), no
    kernel launched (a mixed state takes none, the reference's rule); then
    the same steps at MIXED_CUT on the card and on CPU tensors: equal
    counters, z(1) and gradients within a bound made from the measured
    card-to-CPU drift of one field evaluation and one pullback."""
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    cfgs = _mixed_configs()
    full = {}
    ops.reset_launches()                   # the main path starts here
    for m, ncfg in cfgs.items():
        # a first step (its warm-up cost reported apart), then the timed
        # one from the same weights
        first = None
        for _ in range(2):
            block, x = _mixed_block(torch, seed, NODE18_SHAPE, "cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            r = _mixed_step(torch, block, x, ncfg)
            first = first or (r["fwd_ms"], r["bwd_ms"])
        st = r["stats"]
        finite = all(bool(torch.isfinite(g).all())
                     for g in r["grads"].values())
        full[m] = {"n_steps": int(st.n_steps), "n_trials": int(st.n_trials),
                   "nfe": int(st.nfe), "status": int(st.status),
                   "fwd_ms": r["fwd_ms"], "bwd_ms": r["bwd_ms"],
                   "first_fwd_ms": first[0], "first_bwd_ms": first[1],
                   "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
                   "loss": r["loss"], "finite_grads": finite,
                   "dtypes": [str(r["x"].dtype), str(r["e"].dtype)]}
        emit({"phase": "mixed_dtype_step", "method": m, **full[m]})
        check(full[m]["status"] == 0 and finite
              and math.isfinite(r["loss"]),
              f"mixed_dtype {m}: status, loss or gradients: {full[m]}")
        check(full[m]["dtypes"] == ["torch.bfloat16", "torch.float32"],
              f"mixed_dtype {m}: leaf dtypes {full[m]['dtypes']}")
        del block, x, r
    launches = ops.launch_counts()         # the main path ends here
    fused = {k: launches[k] for k in (*K1_K2, *BATCHED_KERNELS,
                                      *SERVE_KERNELS)}
    check(not any(fused.values()),
          f"mixed_dtype: a mixed state launched K1-K5: {fused}")

    d_field, d_pull = _field_drift(torch, seed)
    cut = {}
    for m, ncfg in cfgs.items():
        runs = {}
        for dev in ("cuda", "cpu"):
            block, x = _mixed_block(torch, seed, MIXED_CUT, dev)
            runs[dev] = _mixed_step(torch, block, x, ncfg)
        a, b = runs["cuda"], runs["cpu"]
        sa, sb = a["stats"], b["stats"]
        counters = [(int(s.n_steps), int(s.n_trials)) for s in (sa, sb)]
        nfe, n = int(sb.nfe), int(sb.n_steps)
        # each evaluation drifts by the measured field drift, and each
        # accepted step rounds the bf16 state once, differently
        x_bound = nfe * d_field + n * BF16_EPS
        e_bound = 2 * x_bound
        g_bound = nfe * d_pull + 2 * n * BF16_EPS

        def rel(u, v):
            return float((u.float().cpu() - v.float()).abs().max()
                         / v.float().abs().max().clamp_min(1e-30))

        errs = {"x": rel(a["x"], b["x"]), "e": rel(a["e"], b["e"]),
                "grads": max(rel(a["grads"][k], b["grads"][k])
                             for k in b["grads"])}
        cut[m] = {"counters_card_cpu": counters, "nfe": nfe,
                  "max_rel": errs, "bounds": {"x": x_bound, "e": e_bound,
                                              "grads": g_bound}}
        check(counters[0] == counters[1],
              f"mixed_dtype {m} at {MIXED_CUT}: card and CPU counters "
              f"differ: {counters}")
        check(errs["x"] <= x_bound and errs["e"] <= e_bound
              and errs["grads"] <= g_bound,
              f"mixed_dtype {m} at {MIXED_CUT}: card vs CPU {cut[m]}")
    emit({"phase": "mixed_dtype", "ok": True, "shape": list(NODE18_SHAPE),
          "state": {"x": "bfloat16", "e": "float32"}, "steps": full,
          "fused_launches": fused, "cut": list(MIXED_CUT),
          "field_drift": d_field, "pullback_drift": d_pull,
          "card_vs_cpu": cut, "seconds": time.perf_counter() - t_phase})


def _smi_name_limit() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}")


def phase_sharded_solve(torch, seed: int):
    """Slice I1. A one-rank NCCL group (``init_distributed("cuda")``) and
    ``shard_mesh()`` over it; the node18 block at full width under
    batch_axis=0 with the kernels (K3/K4), one SGD step per method (aca
    and adjoint and naive on the full buffer, mali as NODE_TRAIN_MALI)
    with ``NodeConfig.mesh`` set, against the same step without a mesh
    from the same weights: z(1), stats, the input's and every parameter's
    gradient bitwise, K3/K4 launches equal; forward / backward / step ms,
    peak memory and the collectives counted. Returns the sharded steps'
    K3/K4 launches."""
    import dataclasses
    import os

    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import node18_cifar
    from repro_torch.distributed import counts, reset_counts, shard_mesh
    from repro_torch.kernels import ops, rk_stage
    from repro_torch.launch.mesh import free_port, init_distributed
    from repro_torch.models.config import RunConfig
    from repro_torch.models.transformer import (TransformerBlock, full_buffer,
                                                node_block)

    t_phase = time.perf_counter()
    os.environ.update({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(free_port())})
    init_distributed("cuda")
    try:
        mesh = shard_mesh()
        card = _smi_name_limit()
        base = dataclasses.replace(full_buffer(node18_cifar.NODE_TRAIN),
                                   batch_axis=0)
        cfgs = {"aca": base,
                "adjoint": dataclasses.replace(base, grad_method="adjoint"),
                "naive": dataclasses.replace(base, grad_method="naive"),
                "mali": dataclasses.replace(node18_cifar.NODE_TRAIN_MALI,
                                            batch_axis=0)}
        block = TransformerBlock(node18_cifar.CONFIG,
                                 RunConfig(compute_dtype=torch.float32),
                                 seed=seed, device="cuda")
        init = {n: p.detach().clone() for n, p in block.named_parameters()}
        x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
            NODE18_SHAPE).astype(np.float32)).cuda()
        opt = torch.optim.SGD(block.parameters(), lr=1e-2)

        def sgd_step(ncfg):
            with torch.no_grad():
                for n, p in block.named_parameters():
                    p.copy_(init[n])
            opt.zero_grad(set_to_none=True)
            xg = x.clone().requires_grad_()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = dict(rk_stage.launches)
            reset_counts()
            t0 = time.perf_counter()
            zT, st = node_block(block, xg, ncfg)
            loss = torch.mean(zT ** 2)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fwd = dict(counts)
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            grads = {n: p.grad.detach().clone()
                     for n, p in block.named_parameters()}
            opt.step()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            return {"zT": zT.detach(), "st": st, "gx": xg.grad, "grads": grads,
                    "launches": {k: rk_stage.launches[k] - before[k]
                                 for k in BATCHED_KERNELS},
                    "collectives_fwd": fwd,
                    "collectives_bwd": {k: counts[k] - fwd[k] for k in fwd},
                    "forward_ms": 1e3 * (t1 - t0),
                    "backward_ms": 1e3 * (t2 - t1),
                    "step_ms": 1e3 * (t3 - t0),
                    "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9}

        def mean(runs, key):
            return sum(r[key] for r in runs) / len(runs)

        times = ("forward_ms", "backward_ms", "step_ms", "peak_mem_GB")
        rows = {}
        total = {k: 0 for k in BATCHED_KERNELS}
        for m, ncfg in cfgs.items():
            sharded_cfg = dataclasses.replace(ncfg, mesh=mesh)
            first_ms = sgd_step(sharded_cfg)["step_ms"]   # warms the pool
            # in turns: unsharded, sharded, sharded, unsharded
            plains = [sgd_step(ncfg)]
            torch.cuda.synchronize()
            ops.reset_launches()           # the main path starts here
            shds = [sgd_step(sharded_cfg) for _ in range(2)]
            launches = dict(rk_stage.launches)   # the main path ends here
            plains.append(sgd_step(ncfg))
            for k in BATCHED_KERNELS:
                total[k] += launches[k]
            plain, shd = plains[0], shds[0]
            same = {
                "zT": torch.equal(shd["zT"], plain["zT"]),
                "stats": all(torch.equal(a, b) for a, b in
                             zip(shd["st"], plain["st"])),
                "x_grad": torch.equal(shd["gx"], plain["gx"]),
                "param_grads": all(torch.equal(shd["grads"][n],
                                               plain["grads"][n])
                                   for n in plain["grads"])}
            st = shd["st"]
            rows[m] = {
                "card": card, "n_steps": st.n_steps.tolist(),
                "n_trials": st.n_trials.tolist(), "status": st.status.tolist(),
                "bitwise": same, "launches": shd["launches"],
                "unsharded_launches": plain["launches"],
                "collectives_fwd": shd["collectives_fwd"],
                "collectives_bwd": shd["collectives_bwd"],
                "first_step_ms": first_ms,
                **{k: mean(shds, k) for k in times},
                "unsharded": {k: mean(plains, k) for k in times},
                "runs_step_ms": [plains[0]["step_ms"], shds[0]["step_ms"],
                                 shds[1]["step_ms"], plains[1]["step_ms"]]}
            emit({"phase": "sharded_solve_step", "method": m, **rows[m]})
            check(all(same.values()) and torch.equal(shds[1]["zT"],
                                                     plain["zT"]),
                  f"sharded_solve {m}: a one-rank mesh is not bitwise the "
                  f"unsharded solve: {same}")
            check(shd["launches"] == plain["launches"]
                  and shd["launches"]["rk_stage_increment_batched"] > 0,
                  f"sharded_solve {m}: K3/K4 launches {shd['launches']} "
                  f"against {plain['launches']} unsharded")
            check(shd["collectives_fwd"] == {"all_gather": 2, "all_reduce": 0}
                  and shd["collectives_bwd"] == {"all_gather": 1,
                                                 "all_reduce": 1},
                  f"sharded_solve {m}: collectives {shd['collectives_fwd']} "
                  f"forward, {shd['collectives_bwd']} backward")
            check(not any(st.status.tolist()),
                  f"sharded_solve {m}: status {st.status.tolist()}")
        check(all(total[k] > 0 for k in BATCHED_KERNELS),
              f"sharded_solve: the sharded steps did not launch K3 and K4: "
              f"{total}")
        emit({"phase": "sharded_solve", "ok": True, "ranks": 1,
              "backend": dist.get_backend(), "mesh": {"data": 1},
              "shape": list(NODE18_SHAPE), "card": card,
              "launches": total, "steps": rows,
              "seconds": time.perf_counter() - t_phase})
    finally:
        dist.destroy_process_group()
    return total


SHARDED_LM_TRAIN = (8, 128)     # node18 at full width: batch, sequence


def _leaf_list(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_leaves(tree)


def _first_divergence(torch, plain, sharded, params, dparams, toks):
    """The first block of the stack whose output differs between the two
    routes' prefill, with its max |difference|: what a failed bitwise
    check names."""
    from repro_torch.distributed.regions import whole
    from repro_torch.models import transformer

    orig = transformer.block_apply
    outs = {}

    def logged(route):
        def fn(*a, **k):
            y = orig(*a, **k)
            outs.setdefault(route, []).append(whole(y[0]).float())
            return y
        return fn

    with torch.no_grad():
        for route, m, p in (("plain", plain, params),
                            ("mesh", sharded, dparams)):
            transformer.block_apply = logged(route)
            try:
                m.prefill(p, {"tokens": toks})
            finally:
                transformer.block_apply = orig
    for i, (a, b) in enumerate(zip(outs["plain"], outs["mesh"])):
        if not torch.equal(a, b):
            return {"first_block": i,
                    "max_abs_diff": float((a - b).abs().max()),
                    "max_abs": float(a.abs().max())}
    return {"first_block": None}


def _sharded_serve(torch, seed: int, mesh, card: str, cfg, call, max_seq,
                   kernels, want):
    """One model whole on the one-rank mesh and off it (weights shared:
    the DTensors wrap the mesh-less tensors), call ``call`` in turns;
    returns the phase line's entry and the mesh route's first-call
    launches."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed import regions
    from repro_torch.kernels import ops
    from repro_torch.models.common import place_params
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServeEngine

    run16 = RunConfig(compute_dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16, use_pallas=True,
                      max_seq=max_seq)
    plain = build_model(cfg, run16)
    sharded = build_model(cfg, run16.with_(mesh=mesh))
    params = plain.init(seed=seed, device="cuda")
    dparams = place_params(params, sharded.defs, sharded.rcfg.rules, mesh)
    wrapped = all(a.to_local().data_ptr() == b.data_ptr() for a, b in zip(
        _leaf_list(dparams), _leaf_list(params)))
    check(wrapped, f"sharded_lm {cfg.name}: placing the weights copied them")
    b, s, new = call
    tgen = torch.Generator(device="cuda").manual_seed(seed + 7)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=tgen,
                         device="cuda", dtype=torch.int32)
    for m, p in ((plain, params), (sharded, dparams)):   # warm-up
        ServeEngine(m, p, ServeConfig(max_new_tokens=2)).generate(
            toks[:, :64])
    torch.cuda.synchronize()

    def run(m, p):
        engine = ServeEngine(m, p, ServeConfig(max_new_tokens=new))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()               # the main path starts here
        t0 = time.perf_counter()
        out = engine.generate(toks)["tokens"]
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = ops.launch_counts()       # the main path ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps = engine.last_decode_steps
        t0 = time.perf_counter()
        engine.prefill(toks)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        return {"out": out, "steps": steps,
                "launches": {k: counts[k] for k in kernels},
                "others": {k: v for k, v in counts.items()
                           if k not in kernels and v},
                "generate_ms": 1e3 * gen_s, "prefill_ms": 1e3 * prefill_s,
                "decode_ms_per_token": 1e3 * (gen_s - prefill_s) / steps,
                "peak_mem_GB": peak}

    runs = [run(plain, params), run(sharded, dparams),
            run(sharded, dparams), run(plain, params)]
    layers = cfg.n_layers
    with torch.no_grad():
        lp, _ = plain.prefill(params, {"tokens": toks})
        regions.reset_counts()
        with CommDebugMode() as comm:
            lm, caches = sharded.prefill(dparams, {"tokens": toks})
        prefill_comm = {"total": comm.get_total_counts(),
                        "explicit": dict(regions.counts)}
        nxt = torch.argmax(lm, dim=-1).to(torch.int32)[:, None]
        regions.reset_counts()
        with CommDebugMode() as comm:
            sharded.decode_step(dparams, {"tokens": nxt}, caches, s)
        decode_comm = {"total": comm.get_total_counts(),
                       "explicit": dict(regions.counts)}
        del caches
    logits_bitwise = bool(torch.equal(lp, lm))
    tokens_bitwise = all(torch.equal(r["out"], runs[0]["out"])
                         for r in runs)
    keys = ("generate_ms", "prefill_ms", "decode_ms_per_token",
            "peak_mem_GB")
    row = {"card": card, "config": cfg.name, "call": list(call),
           "n_params": plain.n_params(), "weights_wrapped": wrapped,
           "logits_bitwise": logits_bitwise,
           "tokens_bitwise": tokens_bitwise,
           "launches": runs[1]["launches"],
           "unsharded_launches": runs[0]["launches"],
           "collectives_prefill": prefill_comm,
           "collectives_decode_step": decode_comm,
           **{k: (runs[1][k] + runs[2][k]) / 2 for k in keys},
           "unsharded": {k: (runs[0][k] + runs[3][k]) / 2 for k in keys},
           "runs_generate_ms": [r["generate_ms"] for r in runs]}
    if not (logits_bitwise and tokens_bitwise):
        row["divergence"] = _first_divergence(torch, plain, sharded, params,
                                              dparams, toks)
    emit({"phase": "sharded_lm_serve", **row})
    w = want(layers, runs[1]["steps"])
    check(logits_bitwise and tokens_bitwise,
          f"sharded_lm {cfg.name}: the one-rank mesh is not bitwise the "
          f"mesh-less call: {row.get('divergence')}")
    check(all(r["launches"] == w and not r["others"] for r in runs),
          f"sharded_lm {cfg.name}: launches "
          f"{[(r['launches'], r['others']) for r in runs]} != {w}")
    return row, runs[1]["launches"]


def _sharded_train(torch, seed: int, mesh, card: str):
    """One AdamW step of node18_cifar at full width (NODE off, f32) on the
    mesh against the step without it, from the same weights and batch."""
    from repro_torch.configs import node18_cifar
    from repro_torch.data import TokenPipeline
    from repro_torch.models.common import place_params
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import TrainLoop, TrainLoopConfig, TrainState
    from repro_torch.train.loop import _grads_of

    cfg = node18_cifar.CONFIG
    rcfg = RunConfig(compute_dtype=torch.float32)
    plain = build_model(cfg, rcfg)
    sharded = build_model(cfg, rcfg.with_(mesh=mesh))
    params = plain.init(seed=seed, device="cuda")
    dparams = place_params(params, sharded.defs, rcfg.rules, mesh)
    bsz, seq = SHARDED_LM_TRAIN
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=bsz,
                          device="cuda").batch(0)
    _grads_of(sharded, dparams, batch)          # warm-up
    torch.cuda.synchronize()
    out = {}
    for name, m, p in (("plain", plain, params), ("mesh", sharded, dparams)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, grads = _grads_of(m, p, batch)
        torch.cuda.synchronize()
        grad_ms = 1e3 * (time.perf_counter() - t0)
        opt = adamw(1e-3, weight_decay=0.1)
        loop = TrainLoop(m, opt, TrainLoopConfig(), TrainState(
            step=torch.zeros((), dtype=torch.int32, device="cuda"),
            params=p, opt_state=opt.init(p)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loop.run(lambda _: batch, 1)
        torch.cuda.synchronize()
        out[name] = {"loss": loss, "grads": grads, "grad_ms": grad_ms,
                     "step_ms": 1e3 * (time.perf_counter() - t0),
                     "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
                     "state": loop.state}
    from repro_torch.distributed.regions import whole

    pl, ms = out["plain"], out["mesh"]
    gp, gm = _leaf_list(pl["grads"]), _leaf_list(ms["grads"])
    grads_bitwise = all(torch.equal(a, whole(b)) for a, b in zip(gp, gm))
    params_bitwise = all(torch.equal(a, whole(b)) for a, b in zip(
        _leaf_list(pl["state"].params),
        _leaf_list(ms["state"].params)))
    st = ms["state"]
    p_leaves = _leaf_list(st.params)
    moments = all(type(a).__name__ == "DTensor"
                  and tuple(a.placements) == tuple(q.placements)
                  for mom in (st.opt_state.mu, st.opt_state.nu)
                  for a, q in zip(_leaf_list(mom), p_leaves))
    row = {"card": card, "config": cfg.name, "batch": list(SHARDED_LM_TRAIN),
           "kernels": "none (NODE off: the train forward runs no kernel)",
           "loss": float(ms["loss"]), "unsharded_loss": float(pl["loss"]),
           "loss_bitwise": bool(torch.equal(ms["loss"], pl["loss"])),
           "grads_bitwise": grads_bitwise,
           "params_after_step_bitwise": params_bitwise,
           "moments_follow_params": moments,
           **{k: ms[k] for k in ("grad_ms", "step_ms", "peak_mem_GB")},
           "unsharded": {k: pl[k] for k in ("grad_ms", "step_ms",
                                            "peak_mem_GB")}}
    emit({"phase": "sharded_lm_train", **row})
    check(row["loss_bitwise"] and grads_bitwise and params_bitwise,
          f"sharded_lm train: not bitwise the mesh-less step: {row}")
    check(moments, "sharded_lm train: the AdamW moments are not DTensors "
          "with their parameters' placements")
    return row


def _node_stats_rows(stats) -> list:
    """Each block's (steps, trials, evaluations, status)."""
    return [[int(s.n_steps), int(s.n_trials), int(s.nfe), int(s.status)]
            for _, _, s in stats]


def _timed_grads(torch, model, params, batch) -> dict:
    """One counted forward and backward of ``model``'s loss (a main path:
    every launch count set to 0 just before, read just after): loss,
    gradients, NODE stats, launches, ms, and the peak allocated above
    what was held before it, in GB."""
    from repro_torch.kernels import ops
    from repro_torch.train.loop import _grads_of

    model.node_stats = []
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                    # the main path starts here
    t0 = time.perf_counter()
    loss, _, grads = _grads_of(model, params, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    return {"loss": loss, "grads": _leaf_list(grads), "ms": ms,
            "stats": _node_stats_rows(model.node_stats),
            "launches": launches,
            "peak_GB": (torch.cuda.max_memory_allocated() - held) / 1e9}


def _add_launches(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def _sharded_node_train(torch, seed: int, mesh, card: str):
    """node18_cifar at full width in NODE mode (NODE_TRAIN: HeunEuler
    1e-2, segmented ACA, K1/K2 on every block), f32, 8 x 128, on the
    one-rank mesh against the mesh-less step from the same weights and
    batch: loss, every gradient and each block's steps bitwise, K1/K2
    launches equal. Returns the row and both routes' launches."""
    from repro_torch.configs import node18_cifar
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed.regions import whole
    from repro_torch.models.common import place_params
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.train.loop import _grads_of

    cfg = node18_cifar.CONFIG
    rcfg = RunConfig(compute_dtype=torch.float32,
                     node=node18_cifar.NODE_TRAIN)
    plain = build_model(cfg, rcfg)
    sharded = build_model(cfg, rcfg.with_(mesh=mesh))
    params = plain.init(seed=seed, device="cuda")
    dparams = place_params(params, sharded.defs, rcfg.rules, mesh)
    bsz, seq = SHARDED_LM_TRAIN
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=bsz,
                          device="cuda").batch(0)
    for m, p in ((plain, params), (sharded, dparams)):
        _grads_of(m, p, batch)              # warm-up
    pl = _timed_grads(torch, plain, params, batch)
    ms = _timed_grads(torch, sharded, dparams, batch)
    grads_bitwise = all(torch.equal(a, whole(b))
                        for a, b in zip(pl["grads"], ms["grads"]))
    row = {"card": card, "config": cfg.name, "batch": list(SHARDED_LM_TRAIN),
           "node": "NODE_TRAIN", "loss": float(ms["loss"]),
           "unsharded_loss": float(pl["loss"]),
           "loss_bitwise": bool(torch.equal(ms["loss"], pl["loss"])),
           "grads_bitwise": grads_bitwise,
           "block_stats": ms["stats"],
           "stats_equal": ms["stats"] == pl["stats"],
           "launches": ms["launches"], "unsharded_launches": pl["launches"],
           "step_ms": ms["ms"], "peak_GB": ms["peak_GB"],
           "unsharded": {"step_ms": pl["ms"], "peak_GB": pl["peak_GB"]},
           "step": "forward and backward"}
    emit({"phase": "sharded_lm_node_train", **row})
    verdict = {k: row[k] for k in ("loss", "unsharded_loss", "loss_bitwise",
                                   "grads_bitwise", "stats_equal")}
    check(row["loss_bitwise"] and grads_bitwise and row["stats_equal"],
          f"sharded_lm NODE train: not bitwise the mesh-less step: "
          f"{verdict}")
    check(ms["launches"] == pl["launches"]
          and all(ms["launches"].get(k, 0) > 0 for k in K1_K2),
          f"sharded_lm NODE train: K1/K2 launches {ms['launches']} on the "
          f"mesh, {pl['launches']} without")
    total = {}
    _add_launches(total, pl["launches"])
    _add_launches(total, ms["launches"])
    return row, total


def phase_sharded_lm(torch, seed: int, moe_peak_GB: float):
    """Slice I2 on a one-rank NCCL mesh (see the module docstring, 11h).
    Returns the mesh routes' K7/K8/K9 launches."""
    import os

    import torch.distributed as dist

    from repro_torch.configs import deepseek_moe_16b, mamba2_2_7b
    from repro_torch.launch.mesh import (free_port, init_distributed,
                                         make_debug_mesh)

    t_phase = time.perf_counter()
    os.environ.update({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(free_port())})
    init_distributed("cuda")
    try:
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        card = _smi_name_limit()
        b, s, new = MOE_CALLS["B"]
        moe_row, moe_l = _sharded_serve(
            torch, seed, mesh, card, deepseek_moe_16b.CONFIG, (b, s, new),
            s + new + 8, MOE_KERNELS,
            lambda layers, steps: {"rmsnorm": (2 * layers + 1) * (1 + steps),
                                   "flash_attention": layers})
        moe_row["serve_moe_call_a_peak_GB"] = moe_peak_GB
        b, s, new = M2_CALLS["B"]
        m2_row, m2_l = _sharded_serve(
            torch, seed, mesh, card, mamba2_2_7b.CONFIG, (b, s, new), 0,
            SSM_KERNELS,
            lambda layers, steps: {"rmsnorm": (2 * layers + 1) * (1 + steps),
                                   "ssd_scan": layers,
                                   **{k: layers for k in K9_PARTS}})
        train_row = _sharded_train(torch, seed, mesh, card)
        node_row, node_l = _sharded_node_train(torch, seed, mesh, card)
        launches = {}
        for got in (moe_l, m2_l, node_l):
            _add_launches(launches, got)
        emit({"phase": "sharded_lm", "ok": True, "ranks": 1,
              "backend": dist.get_backend(), "mesh": {"data": 1, "model": 1},
              "card": card, "launches": launches,
              "deepseek_moe_16b": moe_row, "mamba2_2_7b": m2_row,
              "node18_train": train_row, "node18_node_train": node_row,
              "seconds": time.perf_counter() - t_phase})
    finally:
        dist.destroy_process_group()
    return launches


# ------------------------------------------------------------------ remat


def phase_remat(torch, seed: int):
    """Slice I5's ``RunConfig.remat``: node18_cifar at full width, f32,
    8 x 128, one forward and backward with ``remat="block"`` against
    ``"none"`` from the same weights and batch, NODE off and NODE_TRAIN
    on (K1/K2): loss and every gradient bitwise, each block's stats
    equal and recorded once, peak GB and ms of both; the recompute's
    K1/K2 launches counted (more under block). Returns the launches."""
    from repro_torch.configs import node18_cifar
    from repro_torch.core.node_block import NodeConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.train.loop import _grads_of

    t_phase = time.perf_counter()
    card = _smi_name_limit()
    cfg = node18_cifar.CONFIG
    bsz, seq = SHARDED_LM_TRAIN
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=bsz,
                          device="cuda").batch(0)
    rows, launches = {}, {}
    for label, ncfg in (("node_off", NodeConfig()),
                        ("node_train", node18_cifar.NODE_TRAIN)):
        models = {remat: build_model(cfg, RunConfig(
            compute_dtype=torch.float32, node=ncfg, remat=remat))
            for remat in ("none", "block")}
        params = models["none"].init(seed=seed, device="cuda")
        _grads_of(models["none"], params, batch)    # warm-up
        runs = {remat: _timed_grads(torch, m, params, batch)
                for remat, m in models.items()}
        none, block = runs["none"], runs["block"]
        row = {"loss": float(block["loss"]),
               "loss_bitwise": bool(torch.equal(none["loss"],
                                                block["loss"])),
               "grads_bitwise": all(torch.equal(a, b) for a, b in
                                    zip(none["grads"], block["grads"])),
               "stats_equal": none["stats"] == block["stats"],
               "blocks_recorded": len(block["stats"]),
               **{f"{k}_{remat}": runs[remat][k] for remat in runs
                  for k in ("ms", "peak_GB", "launches")}}
        rows[label] = row
        for got in runs.values():
            _add_launches(launches, got["launches"])
        check(row["loss_bitwise"] and row["grads_bitwise"]
              and row["stats_equal"],
              f"remat {label}: block is not bitwise none: {row}")
        if label == "node_train":
            check(row["blocks_recorded"] == cfg.n_layers,
                  f"remat: {row['blocks_recorded']} NODE stats for "
                  f"{cfg.n_layers} blocks")
            check(all(block["launches"].get(k, 0)
                      > none["launches"].get(k, 0) > 0 for k in K1_K2),
                  f"remat: the recompute's K1/K2 launches "
                  f"{block['launches']} against {none['launches']}")
    emit({"phase": "remat", "ok": True, "card": card, "config": cfg.name,
          "batch": list(SHARDED_LM_TRAIN), "step": "forward and backward",
          **rows, "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


# ------------------------------------------------------ launch and cost

COST_REPS = 3                   # timed prefills a route, in turns
COST_MEM_RTOL = 0.10            # dry-run bytes against max_memory_allocated
COST_TEMP_RTOL = 0.10           # dry-run temp bytes against the peak above
                                # the bytes resident before the call
COST_NODE = (64, 32)            # the NODE dry run's batch and dim
# the whole calls of serve_moe and serve_mamba2 against the roofline,
# filled by _whole_call_cost and reported by phase_cost
WHOLE_CALLS = {}


def _count_keys(cost) -> dict:
    """What a dry run must reproduce of a counted run: FLOPs by dtype,
    bytes (all ops, and the roofline's essential class), collectives and
    hand-kernel entries."""
    return {"flops_by_dtype": dict(cost.flops_by_dtype),
            "bytes": cost.bytes, "bytes_min": cost.bytes_min,
            "coll": dict(cost.coll), "kernels": cost.kernels}


def _whole_call_cost(torch, arch: str, model, params, toks,
                     held_before: int) -> None:
    """Call B's prefill of ``arch`` (``model`` on the kernel route, its
    ``params`` on the card) against the roofline.

    A one-rank mesh of the "fake" backend (no collective is issued on one
    rank) carries the call twice: on the card's tensors under ``OpCost``
    (the kernels launch and count their ``work``), and as the dry run
    (``launch/dryrun.py``: fake tensors, nothing launched). The counts
    must be equal and the mesh route's logits the mesh-less route's bits.
    Memory, over one more mesh call on the card: the dry run's argument +
    temp bytes within COST_MEM_RTOL of ``max_memory_allocated`` less
    ``held_before``, what the process held before the phase drew its
    weights (earlier phases' tensors). The arguments are resident, so the
    argument term is the allocator's, and whatever else the phase holds
    counts against the dry run. And the dry run's temp bytes (the
    counter's peak of live bytes) within COST_TEMP_RTOL of the
    allocator's peak above the bytes resident before the call. Time: the
    mesh-less route (the serving route), COST_REPS calls, median."""
    import statistics

    import torch.distributed as dist

    from repro_torch.distributed.sharding import shard
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models.common import place_params
    from repro_torch.models.lm import build_model

    t_phase = time.perf_counter()
    b, s = toks.shape
    cfg, rcfg = model.cfg, model.rcfg
    mesh = dryrun.fake_mesh((1, 1), ("data", "model"), "cuda")
    try:
        m1 = build_model(cfg, rcfg.with_(mesh=mesh))
        p1 = place_params(params, m1.defs, rcfg.rules, mesh)
        batch = {"tokens": shard(toks, ("batch", "seq"), rcfg.rules, mesh)}
        torch.cuda.synchronize()
        # the calls' caches are dropped ([0]), as the callers' are: held,
        # they would count against the dry run's one call
        ops.reset_launches()               # the main path starts here
        with torch.no_grad(), OpCost() as real:
            logits1 = m1.prefill(p1, batch)[0]
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        with torch.no_grad():              # the main path ended above
            logits0 = model.prefill(params, {"tokens": toks})[0]
        check(torch.equal(logits1, logits0),
              f"{arch}: the one-rank mesh prefill is not the mesh-less "
              "route's bits")
        check(bool(torch.isfinite(logits1.float()).all()),
              f"{arch}: prefill logits not finite")
        del logits1, logits0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            m1.prefill(p1, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()    # arguments resident
        cell = dryrun.build_cell(
            arch, "call_b", mesh, config=cfg, plan=(s, b, "prefill"),
            use_pallas=rcfg.use_pallas, device="cuda",
            max_seq=rcfg.max_seq)
        fake, _, trace_s = dryrun.count_cell(cell)
        args_bytes = dryrun.local_bytes(cell.args)
        mem = args_bytes + fake.peak_bytes

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0)

        with torch.no_grad():
            plain_ms = [timed(lambda: model.prefill(params,
                                                    {"tokens": toks}))
                        for _ in range(COST_REPS)]
        del m1, p1, cell
    finally:
        dist.destroy_process_group()
    want, got = _count_keys(real), _count_keys(fake)
    check(want == got, f"{arch}: the dry run counts {got}, the card's "
          f"kernel-route run {want}")
    check(all(launches.get(k) == v["calls"]
              for k, v in want["kernels"].items()) and want["kernels"],
          f"{arch}: kernel entries {want['kernels']} against launches "
          f"{launches}")
    roof = roofline.analyze(fake, cfg, "prefill", s, b, 1)
    ms = statistics.median(plain_ms)
    WHOLE_CALLS[arch] = {
        "call": [b, s], "card": _smi_name_limit(),
        "flops_by_dtype": got["flops_by_dtype"],
        "bytes_min": got["bytes_min"], "bytes_all": got["bytes"],
        "kernels": {k: v["calls"] for k, v in got["kernels"].items()},
        "launches": launches, "coll": got["coll"],
        "t_compute_ms": 1e3 * roof.t_compute,
        "t_memory_ms": 1e3 * roof.t_memory,
        "bound_ms": 1e3 * roof.bound_time, "dominant": roof.dominant,
        "model_flops": roof.model_flops_global,
        "useful_flop_ratio": roof.useful_flop_ratio,
        "measured_ms": ms, "measured_ms_runs": plain_ms,
        "share_of_bound": 1e3 * roof.bound_time / ms,
        "dry_run_argument_bytes": args_bytes,
        "dry_run_temp_bytes": fake.peak_bytes,
        "held_before_phase": held_before,
        "resident_before_call": base,
        "max_memory_allocated": peak,
        "phase_peak": peak - held_before,
        "memory_rel": abs(mem - (peak - held_before)) / (peak - held_before),
        "peak_above_resident": peak - base,
        "temp_rel": abs(fake.peak_bytes - (peak - base)) / (peak - base),
        "trace_s": trace_s, "seconds": time.perf_counter() - t_phase}
    emit({"phase": "whole_call_cost", "model": arch, **WHOLE_CALLS[arch]})
    check(WHOLE_CALLS[arch]["memory_rel"] <= COST_MEM_RTOL,
          f"{arch}: dry-run argument + temp bytes {mem} against "
          f"max_memory_allocated {peak} less the {held_before} held before "
          f"the phase: beyond {COST_MEM_RTOL}")
    check(WHOLE_CALLS[arch]["temp_rel"] <= COST_TEMP_RTOL,
          f"{arch}: dry-run temp bytes {fake.peak_bytes} against the "
          f"allocator's peak above the resident bytes {peak - base}: "
          f"beyond {COST_TEMP_RTOL}")


def phase_cost(torch):
    """Slice I3 on the card: the NODE dry run (train with the adjoint,
    serve with ACA, batch 64, dim 32) on a one-rank NCCL group with the
    fused path (K3/K4, launched and counted), its report, verdict and
    measured time beside its bound; the whole calls of serve_moe and
    serve_mamba2 (``_whole_call_cost``); and the dry-run CLI in a
    subprocess. Returns the NODE dry runs' kernel launches."""
    import os

    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import free_port
    from repro_torch.launch.node_dryrun import run_node_cell

    t_phase = time.perf_counter()
    card = _smi_name_limit()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    launches, cells = {}, {}
    try:
        batch, dim = COST_NODE
        for kind, method in (("train", "adjoint"), ("serve", "aca")):
            ops.reset_launches()           # the main path starts here
            rep = run_node_cell(kind, batch=batch, dim=dim,
                                grad_method=method, device="cuda",
                                use_pallas=True, save=False)
            got = {k: v for k, v in ops.launch_counts().items() if v}
            for k, v in got.items():       # the main path ended above
                launches[k] = launches.get(k, 0) + v
            roof = rep["roofline"]
            cells[rep["cell"]] = {
                "measured": rep["measured"], "hlo_static": rep["hlo_static"],
                "flops_by_dtype": rep["flops_by_dtype"],
                "kernels": {k: v["calls"] for k, v in rep["kernels"].items()},
                "launches": got, "coll_by_kind": roof["coll_by_kind"],
                "t_compute_ms": 1e3 * roof["t_compute"],
                "t_memory_ms": 1e3 * roof["t_memory"],
                "t_collective_ms": 1e3 * roof["t_collective"],
                "bound_ms": 1e3 * rep["bound_time"],
                "dominant": roof["dominant"],
                "verdict": f"{roof['dominant']}-bound"
                + (", not collective-bound" if not rep["collective_bound"]
                   else ""),
                "share_of_bound": 1e3 * rep["bound_time"]
                / rep["measured"]["solve_ms"]}
            check(rep["measured"]["all_ok"], f"{rep['cell']}: a row failed")
            check(not rep["collective_bound"],
                  f"{rep['cell']}: collective-bound")
            check(got.get("rk_stage_increment_batched", 0) > 0
                  and got.get("rk_stage_combine_err_batched", 0) > 0,
                  f"{rep['cell']}: K3/K4 launches {got}")
            check(2 * rep["kernels"]["rk_stage_increment_batched"]["calls"]
                  == got.get("rk_stage_increment_batched"),
                  f"{rep['cell']}: K3 counted {rep['kernels']} of {got} "
                  "launches (two runs)")
    finally:
        dist.destroy_process_group()
    remat_row = _remat_cost(torch, 0)
    # the dry-run CLI as a user runs it: a full-size cell on pod16x16,
    # fake tensors, no card
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), env.get("PYTHONPATH",
                                                           "")])
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "deepseek_moe_16b", "--shape", "decode_32k"], cwd=str(ROOT),
        env=env, capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    ok_lines = [ln for ln in cli.stdout.splitlines()
                if ln.startswith("[ok]")]
    check(cli.returncode == 0 and len(ok_lines) == 1,
          f"dryrun CLI: exit {cli.returncode}, {cli.stdout[-500:]} "
          f"{cli.stderr[-2000:]}")
    check(set(WHOLE_CALLS) == {"deepseek_moe_16b", "mamba2_2_7b"},
          f"whole calls measured: {sorted(WHOLE_CALLS)}")
    emit({"phase": "cost", "ok": True, "card": card, "node_cells": cells,
          "whole_calls": WHOLE_CALLS, "launches": launches,
          "remat_train_step": remat_row,
          "dryrun_cli": {"line": ok_lines[0], "seconds": cli_s},
          "seconds": time.perf_counter() - t_phase})
    return launches


def _remat_cost(torch, seed: int, device: str = "cuda") -> dict:
    """One ``--remat block`` train step of node18_cifar at full width
    (SHARDED_LM_TRAIN, the dry run's train RunConfig: bf16 compute, f32
    parameters, AdamW, clipping) on a one-rank "fake"-backend mesh,
    counted twice: on the card's tensors under ``OpCost``, and as the dry
    run (``launch/dryrun.py::build_cell``, fake tensors). Their FLOPs by
    dtype must be equal; the rest of the counts are reported."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import node18_cifar
    from repro_torch.distributed.sharding import placements_for
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.optim.grad_utils import CompressionState
    from repro_torch.train.loop import TrainLoopConfig, build_train_step
    from repro_torch.train.state import TrainState

    cfg = node18_cifar.CONFIG
    bsz, seq = SHARDED_LM_TRAIN
    mesh = dryrun.fake_mesh((1, 1), ("data", "model"), device)
    try:
        cell = dryrun.build_cell("node18_cifar", "train", mesh, config=cfg,
                                 plan=(seq, bsz, "train"), remat="block",
                                 device=device)
        fake, _, trace_s = dryrun.count_cell(cell)
        rcfg = RunConfig(mesh=mesh, compute_dtype=torch.bfloat16,
                         param_dtype=torch.float32, max_seq=seq,
                         remat="block")
        model = build_model(cfg, rcfg)
        params = model.init(seed=seed, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        toks = torch.randint(0, cfg.vocab, (bsz, seq), generator=gen,
                             device=device, dtype=torch.int32)
        pl = placements_for(("batch", "seq"), rcfg.rules, mesh, toks.shape)
        batch = {k: DTensor.from_local(v, mesh, pl, run_check=False)
                 for k, v in (("tokens", toks),
                              ("labels", toks.roll(-1, 1)),
                              ("mask", torch.ones(bsz, seq, device=device)))}
        opt = adamw(cosine_warmup(3e-4, 100, 10000), weight_decay=0.1)
        step = build_train_step(model, opt, TrainLoopConfig(
            microbatches=1, clip_norm=1.0, compression="none"))
        state = TrainState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            params=params, opt_state=opt.init(params))
        with torch.enable_grad(), OpCost() as real:
            out = step(state, batch, CompressionState(error=()))
        loss = float(out[2]["loss"])
    finally:
        dist.destroy_process_group()
    want, got = _count_keys(real), _count_keys(fake)
    row = {"config": cfg.name, "batch": list(SHARDED_LM_TRAIN),
           "remat": cell.remat, "loss": loss,
           "card_flops_by_dtype": want["flops_by_dtype"],
           "dry_run_flops_by_dtype": got["flops_by_dtype"],
           "counts_equal": want == got,
           "card_bytes": want["bytes"], "dry_run_bytes": got["bytes"],
           "dry_run_temp_bytes": fake.peak_bytes, "trace_s": trace_s}
    check(row["remat"] == "block" and math.isfinite(loss),
          f"remat cost: {row}")
    check(want["flops_by_dtype"] == got["flops_by_dtype"],
          f"remat cost: the dry run counts FLOPs {got['flops_by_dtype']}, "
          f"the card's step {want['flops_by_dtype']}")
    return row


ANALYSIS_QS_FACTOR = 10.0       # quickstart: card rel err <= 10x the CPU's
ANALYSIS_KERNELS = ("rk_stage_increment", "rk_stage_combine_err",
                    "rk_stage_increment_batched",
                    "rk_stage_combine_err_batched",
                    "rk_stage_combine_err_batched_rowtol")


def _analysis_kernel_checks(torch, seed: int, dim: int, rows: int):
    """K1/K2 at the analysis configs' solo state (dim,) and K3/K4/K5 at
    their batched state (rows, dim) and the serving row (rows, dim + 2),
    f32, HeunEuler and Dopri5 rows, against their plain versions on random
    inputs: z_next bitwise, K2's norm within NORM_RTOL and its err within
    ERR_RTOL, K4/K5's per-row norms within ROW_NORM_RTOL. These launches
    are comparisons, outside every counted run. Returns each kernel's max
    |diff|."""
    from repro_torch.core.tableaus import DOPRI5, HEUN_EULER
    from repro_torch.kernels import rk_stage
    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    worst = dict.fromkeys(ANALYSIS_KERNELS, 0.0)

    def gap(name, a, b):
        d = float((a.float() - b.float()).abs().max())
        worst[name] = max(worst[name], d)
        return d

    def stage_rows(tab):
        return ([(i, tab.a[i]) for i in range(1, tab.stages)]
                + [(tab.stages, tab.b)])

    z = torch.randn(dim, generator=gen, device="cuda")
    k = torch.randn(7, dim, generator=gen, device="cuda")
    h = torch.full((), 0.0375, device="cuda")
    for tab in (HEUN_EULER, DOPRI5):
        for i, a in stage_rows(tab):
            kk = k[:i].contiguous()
            out = rk_stage.rk_stage_increment(z, kk, h, a)
            ref = rk_stage.increment_plain(z, kk, h, a)
            d = gap("rk_stage_increment", out, ref)
            check(torch.equal(out, ref), f"analysis K1 {tab.name} row {i} "
                  f"n={dim}: not bitwise the plain version ({d})")
        kk = k[:tab.stages].contiguous()
        for with_err in (True, False):
            zn, err, part = rk_stage.rk_stage_combine_err(
                z, kk, h, tab.b, tab.b_err, 1e-2, 1e-2, with_err=with_err)
            zp, ep, sqp = rk_stage.combine_err_plain(
                z, kk, h, tab.b, tab.b_err, 1e-2, 1e-2, with_err)
            d = gap("rk_stage_combine_err", zn, zp)
            check(torch.equal(zn, zp), f"analysis K2 {tab.name} n={dim}: "
                  f"z_next not bitwise the plain version ({d})")
            sq, sq_p = float(part.sum()), float(sqp.sum())
            check(abs(sq - sq_p) <= NORM_RTOL * abs(sq_p),
                  f"analysis K2 {tab.name} n={dim}: norm {sq} vs {sq_p}")
            if with_err:
                d = gap("rk_stage_combine_err", err, ep)
                check(d <= ERR_RTOL * float(ep.abs().max()),
                      f"analysis K2 {tab.name} n={dim}: err |diff| {d}")

    def norms_close(part, sq_plain, what):
        sq = part.sum(dim=-1)
        bad = (sq - sq_plain).abs() > ROW_NORM_RTOL * sq_plain.abs()
        check(not bool(bad.any()), f"analysis {what}: per-row norms "
              f"{sq.tolist()} vs plain {sq_plain.tolist()}")

    rt = torch.logspace(-2, -4, rows, device="cuda")
    at = 0.1 * rt
    for n in (dim, dim + 2):
        z = torch.randn(rows, n, generator=gen, device="cuda")
        k = torch.randn(7, rows, n, generator=gen, device="cuda")
        h = torch.linspace(0.01, 0.08, rows, device="cuda")
        for tab in (HEUN_EULER, DOPRI5):
            for i, a in stage_rows(tab):
                kk = k[:i].contiguous()
                out = rk_stage.rk_stage_increment_batched(z, kk, h, a)
                ref = rk_stage.increment_batched_plain(z, kk, h, a)
                d = gap("rk_stage_increment_batched", out, ref)
                check(torch.equal(out, ref), f"analysis K3 {tab.name} row "
                      f"{i} ({rows}, {n}): not bitwise the plain version "
                      f"({d})")
            kk = k[:tab.stages].contiguous()
            args = (z, kk, h, tab.b, tab.b_err)
            for name, fn, tols in (
                    ("rk_stage_combine_err_batched",
                     rk_stage.rk_stage_combine_err_batched, (1e-2, 1e-2)),
                    ("rk_stage_combine_err_batched_rowtol",
                     rk_stage.rk_stage_combine_err_batched_rowtol,
                     (rt, at))):
                zn, part = fn(*args, *tols)
                zp, sqp = rk_stage.combine_err_batched_plain(*args, *tols)
                d = gap(name, zn, zp)
                what = f"{name} {tab.name} ({rows}, {n})"
                check(torch.equal(zn, zp),
                      f"analysis {what}: z_next not bitwise ({d})")
                norms_close(part, sqp, what)
    torch.cuda.synchronize()
    return worst


def _analysis_inputs(cfg, seed: int):
    """Seeded nonzero (z0, w) of the config's shapes: z0 standard normal,
    the decay rates w uniform in [hi / 10, hi], hi = 1 (0.1 for MALI,
    whose second-order steps at the default 1e-6 tolerance fit the 64-step
    buffer only for slow decay)."""
    import numpy as np
    z0, w, _ = cfg.example_args("cpu")
    rng = np.random.default_rng(seed)
    hi = 0.1 if cfg.grad_method == "mali" else 1.0
    return (rng.standard_normal(tuple(z0.shape)).astype(np.float32),
            rng.uniform(hi / 10, hi, tuple(w.shape)).astype(np.float32))


def _analysis_routes(torch, cfg, seed: int) -> dict:
    """A ``-pallas`` config on seeded nonzero inputs on the card through
    the kernels and through the plain route (``use_pallas=False``): steps,
    trials and status equal and every status OK, ys bitwise, dL/dz0 and
    dL/dw within PALLAS_GRAD_RTOL (the method_costs bound). These runs are
    comparisons, outside every counted run."""
    import dataclasses
    inputs = _analysis_inputs(cfg, seed)
    kern = cfg.run("cuda", inputs=inputs)
    plain = dataclasses.replace(cfg, use_pallas=False).run("cuda",
                                                           inputs=inputs)
    counts = [[getattr(r.stats, f).reshape(-1).tolist()
               for f in ("n_steps", "n_trials", "status")]
              for r in (kern, plain)]
    check(counts[0] == counts[1], f"analysis {cfg.name} routes: (steps, "
          f"trials, status) {counts[0]} against plain {counts[1]}")
    check(not any(counts[0][2]), f"analysis {cfg.name}: status "
          f"{counts[0][2]} on nonzero inputs")
    check(torch.equal(kern.ys, plain.ys), f"analysis {cfg.name}: ys not "
          "bitwise the plain route's")
    rels = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(kern.grads, plain.grads)]
    check(all(r <= PALLAS_GRAD_RTOL for r in rels),
          f"analysis {cfg.name}: gradients (z0, w) {rels} from the plain "
          f"route's, beyond {PALLAS_GRAD_RTOL}")
    return {"n_steps": counts[0][0], "ys_bitwise": True, "grad_rel": rels,
            "grads_bitwise": all(torch.equal(a, b) for a, b in
                                 zip(kern.grads, plain.grads))}


def phase_analysis(torch, seed: int):
    """Slice I4 on the card: every configuration of the analyzer's matrix
    (``repro_torch.analysis``, the reference's 37) run on CUDA tensors
    through the front door under a ``Recorder``, the ``-pallas`` ones on
    K1/K2 (solo) and K3/K4/K5 (batched, sharded, row-tolerance), with no
    finding of the four passes; each against a CPU run of the same config
    in the same process: the host reads of every loop (before its first
    iteration and per iteration) and outside loops, the collectives (one
    NCCL rank for the card, gloo for the CPU, one default group with both
    backends) and the residual bytes equal; each config's K1-K5 launches
    equal to the kernel entries its run recorded. K1-K5 against their
    plain versions at these shapes (``_analysis_kernel_checks``), and each
    ``-pallas`` config through both routes on nonzero inputs
    (``_analysis_routes``). Then the quickstart on the card and on the
    CPU: each method's relative error against the analytic gradient at
    most ANALYSIS_QS_FACTOR x the CPU's. Returns the card runs' kernel
    launches and each kernel's max |diff| from its plain version."""
    import torch.distributed as dist

    from repro_torch.analysis import MATRIX
    from repro_torch.analysis.rules import analyze_run, profile, runs
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import free_port

    t_phase = time.perf_counter()
    card = _smi_name_limit()
    torch.cuda.set_device(0)
    worst = _analysis_kernel_checks(torch, seed, MATRIX[0].dim,
                                    MATRIX[0].batch)
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method="tcp://"
                            f"127.0.0.1:{free_port()}", rank=0, world_size=1)
    launches, configs, findings, routes = {}, {}, [], {}
    try:
        ops.reset_launches()               # the first config's run starts
        for cfg, run in runs(MATRIX, "cuda"):
            # this config's card run ended as the loop handed it over
            got = {k: v for k, v in ops.launch_counts().items() if v}
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            cpu = cfg.run("cpu")
            found = analyze_run(run) + analyze_run(cpu)
            findings += [f.render() for f in found]
            p_card, p_cpu = profile(run), profile(cpu)
            check(p_card == p_cpu, f"analysis {cfg.name}: the card's run "
                  f"{p_card} differs from the CPU's {p_cpu}")
            check(got == run.recorder.kernels,
                  f"analysis {cfg.name}: launches {got} against the kernel "
                  f"entries {run.recorder.kernels}")
            check(bool(got) == cfg.use_pallas,
                  f"analysis {cfg.name}: launches {got}")
            if cfg.use_pallas:
                routes[cfg.name] = _analysis_routes(torch, cfg, seed)
            loops = {}
            for kind, _, entry, reads in p_card["loops"]:
                n, e, m = loops.get(kind, (0, 0, 0))
                loops[kind] = (n + len(reads), max(e, entry),
                               max(m, max(reads, default=0)))
            configs[cfg.name] = {
                "ms": 1e3 * run.seconds,
                "residual_bytes": p_card["residual_bytes"],
                "budget": cfg.residual_budget_bytes(),
                "loops": {k: {"iterations": n, "entry_reads": e,
                              "max_reads": m}
                          for k, (n, e, m) in loops.items()},
                "reads_outside": len(p_card["reads_outside"]),
                "collectives": len(p_card["collectives"]),
                "launches": got}
            ops.reset_launches()           # the next config's run starts
    finally:
        dist.destroy_process_group()
    check(not findings, f"analysis: findings {findings}")
    for k in ANALYSIS_KERNELS:
        check(launches.get(k, 0) > 0, f"analysis: {k} never launched")
    matrix_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    qs_card = quickstart.run("cuda")
    qs_card_s = time.perf_counter() - t0
    qs_cpu = quickstart.run("cpu")
    qs = {}
    for method, g in qs_card["grads"].items():
        ref = qs_cpu["grads"][method]
        qs[method] = {"card_rel_err": g["rel_err"], "cpu_rel_err":
                      ref["rel_err"], "card_steps": g["n_steps"],
                      "cpu_steps": ref["n_steps"], "card_grad": g["grad"],
                      "cpu_grad": ref["grad"]}
        check(g["rel_err"] <= ANALYSIS_QS_FACTOR * ref["rel_err"],
              f"quickstart {method}: rel err {g['rel_err']} on the card "
              f"against {ref['rel_err']} on the CPU")
    check(qs_card["node_block"]["finite"]
          and qs_card["node_block"]["out"] == qs_card["node_block"]["in"],
          f"quickstart NODE block {qs_card['node_block']}")
    emit({"phase": "analysis", "ok": True, "card": card,
          "configs": configs, "findings": 0, "launches": launches,
          "kernel_max_abs_err": worst, "err_rtol": ERR_RTOL,
          "norm_rtol": NORM_RTOL, "row_norm_rtol": ROW_NORM_RTOL,
          "routes": routes, "grad_rtol": PALLAS_GRAD_RTOL,
          "matrix_seconds": matrix_s, "quickstart": qs,
          "quickstart_card_seconds": qs_card_s,
          "seconds": time.perf_counter() - t_phase})
    return launches, worst


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights and inputs")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke runs only on a card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not at {SRC}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # full f32 matmuls on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase = "build"
    try:
        phase_build()
        phase = "kernels"
        worst, timings, k6_launches = phase_kernels(torch, args.seed)
        phase = "toy_gradient"
        phase_toy_gradient(torch)
        phase = "node18_block"
        launches, _ = phase_node18(torch, args.seed)
        phase = "kernels_batched"
        worst_b, timings_b = phase_kernels_batched(torch, args.seed)
        phase = "serve_node18"
        serve_launches, _ = phase_serve_node18(torch, args.seed)
        phase = "node18_batched"
        batched_launches, _ = phase_node18_batched(torch, args.seed)
        phase = "node18_methods"
        methods_launches, worst_m, aug_times = phase_node18_methods(
            torch, args.seed)
        phase = "segmented_dense"
        dense_launches, worst_d, bmid_times, aca_memory = \
            phase_segmented_dense(torch, args.seed)
        phase = "solve_health_mali"
        mali_launches, worst_s, drift_times = phase_solve_health_mali(
            torch, args.seed, aca_memory)
        phase = "paper_benchmarks"
        paper_launches = phase_paper_benchmarks(torch)
        phase = "kernels_lm"
        worst_lm, timings_lm = phase_kernels_lm(torch, args.seed)
        phase = "serve_recurrentgemma"
        lm_launches, lm_calls = phase_serve_recurrentgemma(torch, args.seed)
        phase = "kernels_ssm"
        worst_ssm, timings_ssm = phase_kernels_ssm(torch, args.seed)
        phase = "serve_mamba2"
        ssm_launches, ssm_calls = phase_serve_mamba2(torch, args.seed)
        phase = "serve_moe"
        moe_launches, moe_calls, k8_moe = phase_serve_moe(torch, args.seed)
        phase = "serve_dense_lms"
        dense_lm_launches, dense_lm_calls, k8_dense, k7_dense = \
            phase_serve_dense_lms(torch, args.seed)
        phase = "train_node_lm"
        lm_train_launches, _ = phase_train_node_lm(torch, args.seed)
        phase = "serve_node_bench"
        bench_serve_launches = phase_serve_node_bench(torch, args.seed)
        phase = "batched_solve"
        phase_batched_solve(torch)
        phase = "mixed_dtype"
        phase_mixed_dtype(torch, args.seed)
        phase = "sharded_solve"
        sharded_launches = phase_sharded_solve(torch, args.seed)
        phase = "sharded_lm"
        sharded_lm_launches = phase_sharded_lm(
            torch, args.seed, moe_calls["A"]["peak_mem_GB"])
        phase = "remat"
        remat_launches = phase_remat(torch, args.seed)
        phase = "cost"
        cost_launches = phase_cost(torch)
        phase = "analysis"
        analysis_launches, worst_a = phase_analysis(torch, args.seed)
    except Exception as exc:
        emit({"phase": phase, "ok": False,
              "error": f"{type(exc).__name__}: {exc}"})
        raise

    # launches: K1/K2 from the node18 block steps, the three methods'
    # steps (solo and fixed regime) and the paper benchmarks' method_costs
    # aca_pallas row, K3 from the serve rounds (serve_node18's and
    # serve_node_bench's), the batched
    # block steps, the batched methods' steps and the sharded steps, K4
    # from the batched block, methods' and sharded steps, K5 from the
    # serve rounds (both phases);
    # times at each
    # path's shape (K3 and K5 at the serving row, K4 at the batched block
    # row; K1-K4 also at the adjoint's augmented shapes)
    worst.update(worst_b)
    for k, v in (list(worst_m.items()) + list(worst_d.items())
                 + list(worst_s.items()) + list(worst_a.items())):
        worst[k] = max(worst[k], v)
    batch_launch = {
        "rk_stage_increment_batched":
        serve_launches["rk_stage_increment_batched"]
        + bench_serve_launches["rk_stage_increment_batched"]
        + batched_launches["rk_stage_increment_batched"]
        + methods_launches["rk_stage_increment_batched"]
        + dense_launches["rk_stage_increment_batched"]
        + mali_launches["rk_stage_increment_batched"]
        + sharded_launches["rk_stage_increment_batched"]
        + cost_launches.get("rk_stage_increment_batched", 0)
        + analysis_launches["rk_stage_increment_batched"],
        "rk_stage_combine_err_batched":
        batched_launches["rk_stage_combine_err_batched"]
        + methods_launches["rk_stage_combine_err_batched"]
        + dense_launches["rk_stage_combine_err_batched"]
        + sharded_launches["rk_stage_combine_err_batched"]
        + cost_launches.get("rk_stage_combine_err_batched", 0)
        + analysis_launches["rk_stage_combine_err_batched"],
        "rk_stage_combine_err_batched_rowtol":
        serve_launches["rk_stage_combine_err_batched_rowtol"]
        + bench_serve_launches["rk_stage_combine_err_batched_rowtol"]
        + analysis_launches["rk_stage_combine_err_batched_rowtol"],
    }
    launches = {**{k: launches[k] + methods_launches[k] + paper_launches[k]
                   + dense_launches[k] + mali_launches.get(k, 0)
                   + lm_train_launches[k] + analysis_launches[k]
                   + sharded_lm_launches.get(k, 0) + remat_launches[k]
                   for k in K1_K2},
                **batch_launch, "rk_stage_combine": k6_launches}
    entries = [
        ("rk_stage_increment", "src/repro/kernels/rk_stage.py:209",
         timings["k1_heun_stage"]),
        ("rk_stage_combine_err", "src/repro/kernels/rk_stage.py:269",
         timings["k2_heun"]),
        ("rk_stage_increment_batched", "src/repro/kernels/rk_stage.py:357",
         timings_b[f"k3_heun_stage_{SERVE_ROW_N}"]),
        ("rk_stage_combine_err_batched",
         "src/repro/kernels/rk_stage.py:419",
         timings_b[f"k4_heun_{ROW_N}"]),
        ("rk_stage_combine_err_batched_rowtol",
         "src/repro/kernels/rk_stage.py:499",
         timings_b[f"k5_heun_{SERVE_ROW_N}"]),
        ("rk_stage_combine", "src/repro/kernels/rk_stage.py:151",
         timings["k6_heun"]),
    ]
    entries = [(name, "rk_stage", replaces, t)
               for name, replaces, t in entries]
    worst.update(worst_lm)
    worst.update(worst_ssm)
    worst["flash_attention"] = max(
        worst["flash_attention"],
        *(t["max_abs_err"] for t in (*k8_moe.values(), *k8_dense.values())))
    worst["rmsnorm"] = max(worst["rmsnorm"],
                           *(t["max_abs_err"] for t in k7_dense.values()))
    # K7 runs on the four LM serving paths and the sharded LM's, K8 on
    # three of them and the sharded MoE, K9 on Mamba-2's two: launches add
    # up
    launches.update(lm_launches)
    launches["rmsnorm"] += ssm_launches["rmsnorm"] + moe_launches["rmsnorm"] \
        + dense_lm_launches["rmsnorm"] + sharded_lm_launches["rmsnorm"]
    launches["flash_attention"] += moe_launches["flash_attention"] \
        + dense_lm_launches["flash_attention"] \
        + sharded_lm_launches["flash_attention"]
    for k in ("ssd_scan",) + K9_PARTS:
        launches[k] = ssm_launches[k] + sharded_lm_launches[k]
    # and the cost phase's whole calls (DeepSeek-MoE's and Mamba-2's)
    for call in WHOLE_CALLS.values():
        for k, n in call["launches"].items():
            launches[k] += n
    k7_variants = {}
    for c in (*lm_calls.values(), *ssm_calls.values(),
              *moe_calls.values(), *dense_lm_calls.values()):
        for k, n in c["rmsnorm_kernels"].items():
            k7_variants[k] = k7_variants.get(k, 0) + n
    # K8's launches by kernel over the serving calls (RecurrentGemma,
    # DeepSeek-MoE, the six dense cuts; serve_moe checks MusicGen's alike)
    k8_variants = {}
    for c in (*lm_calls.values(), *moe_calls.values(),
              *dense_lm_calls.values()):
        for k, n in c["flash_attention_kernels"].items():
            k8_variants[k] = k8_variants.get(k, 0) + n
    entries += [
        ("rmsnorm", "rmsnorm", "src/repro/kernels/rmsnorm.py:27",
         timings_lm["rmsnorm"]),
        ("flash_attention", "flash_attention",
         "src/repro/kernels/flash_attention.py:94",
         timings_lm["flash_attention"]),
        ("ssd_scan", "ssd_scan", "src/repro/kernels/ssd_scan.py:84",
         timings_ssm["ssd_scan"]),
        *((k, "ssd_scan", "src/repro/kernels/ssd_scan.py:84", timings_ssm[k])
          for k in K9_PARTS),
        ("rg_lru", "rg_lru", "src/repro/kernels/rg_lru.py:52",
         timings_lm["rg_lru"]),
    ]
    # K7's decode rows and the launches of each of its two kernels, K8 at
    # window 0 beside SDPA's causal call, K10 at call B's shape, K3 and K5
    # at the batched block's aligned rows beside the serving row's "ms"
    # (K4 the other way round), K5 also on one serving row
    def aug(label):
        t = aug_times[label]
        return {"adjoint_aug_ms": t["ms"], "adjoint_aug_plain_ms":
                t["plain_ms"], "adjoint_aug_bound_ms": t["bound_ms"]}

    def b_mid(label):
        t = bmid_times[label]
        return {"b_mid_ms": t["ms"], "b_mid_plain_ms": t["plain_ms"],
                "b_mid_bound_ms": t["bound_ms"],
                "b_mid_library_ms": t["library_ms"]}

    def half_drift(label):
        t = drift_times[label]
        return {"half_drift_ms": t["ms"], "half_drift_plain_ms":
                t["plain_ms"], "half_drift_bound_ms": t["bound_ms"],
                "half_drift_library_ms": t["library_ms"]}

    extras = {
        "rk_stage_increment": {**aug("k1"), **b_mid("k1_b_mid"),
                               **half_drift("k1_half_drift")},
        "rk_stage_combine_err": aug("k2"),
        "rg_lru": {
            "call_b_ms": timings_lm["rg_lru_call_b"]["ms"],
            "call_b_bound_ms": timings_lm["rg_lru_call_b"]["bound_ms"]},
        "rk_stage_increment_batched": {
            "aligned_rows_ms": timings_b[f"k3_heun_stage_{ROW_N}"]["ms"],
            **aug("k3"), **b_mid(f"k3_b_mid_{SERVE_ROW_N}"),
            **half_drift("k3_half_drift"),
            "b_mid_aligned_rows_ms": bmid_times[f"k3_b_mid_{ROW_N}"]["ms"]},
        "rk_stage_combine_err_batched": {
            "serving_row_ms": timings_b[f"k4_heun_{SERVE_ROW_N}"]["ms"],
            **aug("k4")},
        "rk_stage_combine_err_batched_rowtol": {
            "aligned_rows_ms": timings_b[f"k5_heun_{ROW_N}"]["ms"],
            "one_row_ms": timings_b[f"k5_heun_b1_{SERVE_ROW_N}"]["ms"],
            "one_row_bound_ms":
            timings_b[f"k5_heun_b1_{SERVE_ROW_N}"]["bound_ms"]},
        "rmsnorm": {
            "kernel_launches": k7_variants,
            "decode_ms": {str(timings_lm[k]["shape"][1]): timings_lm[k]["ms"]
                          for k in ("rmsnorm_decode", "rmsnorm_decode_2560",
                                    "rmsnorm_decode_5120")},
            # at the prefill rows of each RMSNorm config of serve_dense_lms
            **{f"{key}_{f}": t[f] for key, t in k7_dense.items()
               for f in ("shape", "ms", "plain_ms", "bound_ms",
                         "library_ms", "max_abs_err")}},
        "flash_attention": {
            "design": "bf16 at head dims 64, 128, 256: flash_fwd_wgmma, "
                      "wgmma for S = Q K^T (SS) and O += P V (P from "
                      "registers, V MN-major), TMA loads of Q and a "
                      "2-stage K/V ring with full and split K/V empty "
                      "mbarriers, one producer warpgroup and two 64-row "
                      "consumer warpgroups (setmaxnreg 24/240) in ping-pong, "
                      "the softmax beside the next products",
            "kernel_rule": {"wgmma": [64, 128, 256], "mma_sync": [16, 32],
                            "f32": "float32, every head dim"},
            "kernel_launches": k8_variants,
            "second_kernel": {
                "name": "flash_fwd_mma_sync", "head_dims": [16, 32],
                **{f: timings_lm["flash_attention_mma_sync"][f]
                   for f in ("shape", "ms", "plain_ms", "bound_ms",
                             "library_ms")}},
            "causal_ms": timings_lm["flash_attention_causal"]["ms"],
            "causal_library_ms":
            timings_lm["flash_attention_causal"]["library_ms"],
            # causal at deepseek_moe_16b's and musicgen_medium's prefill,
            # and at the head layout of each serve_dense_lms config
            **{f"{key}_{f}": t[f]
               for key, t in (*k8_moe.items(), *k8_dense.items())
               for f in ("shape", "ms", "plain_ms", "bound_ms",
                         "library_ms", "max_abs_err")},
            **{f"{key}_kv_heads": t["kv_heads"]
               for key, t in k8_dense.items()}},
    }
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{src}.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": worst[name], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
         "bound_by": t["bound_by"], "library_ms": t["library_ms"],
         # no kernel takes less than one launch (an empty kernel's time)
         "launch_floor_ms": timings_lm["launch_floor"]["ms"],
         # K6 is on no path: its launches are the kernels phase's own
         "main_path": name != "rk_stage_combine",
         **extras.get(name, {})}
        for name, src, replaces, t in entries]})
    print(_smi_name_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
