#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and
``nvcc``; imports torch, numpy and ``repro_torch`` only.  Any failure
exits non-zero before the last line is printed.  Phases:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print the build time;
3. every distinct conv and FC op of the alexnet-owt and resnet18
   Programs at batch 8, and of their SNOWFLAKE paper-faithful Programs
   (every conv on materialized strips), on real activations (the plain
   forward's), through the kernel's wrapper and its plain version: max
   |err| (atol = rtol = 1e-4: f32 sums in another order over reductions
   of up to 9216 terms), and the device time of the kernel, the plain
   version, and the library yardstick (cuDNN ``F.conv2d`` on the whole
   maps or ``torch.addmm``, plus the same epilogue): 20 calls captured
   in one CUDA graph, so the host's launch latency is not in the
   reading.  A materialized conv also prints the strip copy's own time,
   the maps' bytes against the strip buffer's, and the HBM bytes
   ``core/dataflow.py::conv_strip_traffic`` models for it; its bound
   counts the strip buffer read once and only the OH rows' FLOPs.  Each
   conv row ends with ``conv_plan``'s launch (pixel tile, splits and
   slices of K, CTAs, a fused pool's pooled tile and conv region); the
   kernels' ptxas lines (registers, spills) print after the build.  Then
   every conv of the alexnet-owt zero-copy and paper-faithful Programs
   again in bf16 (maps, weights, bias, bypass), both kernels against
   their plain versions at atol = rtol = 2^-7, untimed;
4. every distinct flash-attention, decode-attention and matmul op of the
   smollm-360m (prefill, decode) Program pair at full width, 8 slots,
   max_len 512, of the same pair with a 128-row window, and of the
   zamba2-7b pair (its shared block's attention at head dim 112: 32 q
   over 32 kv heads, S = 512, window 4096, causal), on random
   operands in the executor's layouts (decode: 8 sequences with mixed
   kv_len, some of them a full, wrapped ring).  Each op is checked in
   f32 (atol = rtol = 1e-4) and in bf16 (atol = rtol = 2^-7: kernel and
   plain version both sum in f32 and round once to bf16, so they may
   land on neighbouring bf16 values, one ulp apart) and timed in bf16,
   the main path's type; the library yardsticks are
   ``F.scaled_dot_product_attention`` (GQA, with the mask) and
   ``torch.addmm`` plus the epilogue.  ``bound_ms`` is max(FLOPs / the
   operand type's peak, bytes / HBM rate) from the data sheet of the
   card named, counting each input read once, each output written once
   and only the unmasked work (causal and window pairs, live cache
   rows).  Each decode row prints ``decode_plan``'s split (splits x
   split rows, tile rows, CTAs) and is also checked over a float8 e4m3
   cache (the config's ``kv_dtype="float8"``) under bf16 q (2^-7) and
   f32 q (1e-4).  The paged decode op runs at the same
   width and lengths over (257, 16, 5, 64) pools through a table of
   shuffled page ids, two pairs of sequences sharing pages: f32 (1e-4),
   bf16 (2^-7) and int8 pools with bf16 q (2^-7), each with its plan;
   its bound counts each distinct live page row once, and beside it are
   timed the contiguous kernel at the same lengths and, as the library
   yardstick, SDPA over the already-gathered view.  The same operands at
   head dim 112 in bf16 and int8 pools (bf16 q, 2^-7) are checked, not
   timed.  The flash-attention backward runs at the training shape (batch
   8, 15 q / 5 kv heads of 64, 512 rows): causal, window 128 and a
   kv_len = 450 mask, f32 (1e-4) and bf16 (one bf16 ulp plus the f32
   rounding bound of the plain version's sums, ``bwd_slack``), on the
   forward kernel's out and lse, against its plain version; the causal
   case also on simt in bf16 (operands off a 16-byte boundary) at one
   bf16 ulp; the trainable wrapper
   (forward and backward kernels under autograd) against ``flash_ref``'s
   autograd in f32 (1e-4); then timed in bf16, causal, beside the forward
   kernel at the same shape (with its plain version, SDPA's forward and
   its bound) and SDPA's backward (forward + backward minus forward: no
   single PyTorch call computes the backward alone).  Its
   bound counts 5 products of 2 D FLOP per unmasked (q, k) pair and the
   bytes of q, k, v, out, dO, lse, dq, dk and dv.  The recurrent kernels
   against their plain versions (the sequential f32 recurrence), f32 at
   1e-4 and bf16 at 2^-7 (their f32 final states at 1e-4): mamba2_scan at
   zamba2-7b's admission (1, 512, 112, 64), N = 64, with and without h0,
   its decode tick (8, 1, 112, 64), an L of 300 (not a multiple of the
   kernels' 64-step chunk) and L = 2048 (32 chunks), on strided column
   slices as the model hands them; wkv6 at rwkv6-7b's admission (1, 512,
   64, 64), with and without s0, a short L, L = 2048 and head dim 48.
   Each case prints the plan it ran on (``ssd_plan``: step or chunked
   path, chunks, CTAs, kernels; ``wkv_plan``: chunks, CTAs, rows a
   thread).  The served shapes, L = 2048 and D = 48 are timed in bf16,
   per launch; their bound counts 5 N P (scan) or 5 D^2 (wkv) f32 FLOP
   per step and head and each operand moved once, and beside it the
   chunk-form bound: the chunked scan's products at the TF32 tensor-core
   rate (3xTF32 issues an f32 product three times, one with a bf16 side
   twice), the chunked wkv's work at the f32 FMA rate.  No PyTorch call
   computes either, so neither has a library yardstick;
   Each matmul row names the path ``matmul_plan`` gives it (skinny at
   M <= 64, wgmma for bf16 above, simt for the f32 checks at M = 512),
   and the bf16 matmul rows are summed per smollm-360m and zamba2-7b
   admission and decode tick, the f32 ones per alexnet-owt tick, with
   their launches, ``library_ms`` and ``bound_ms``.  The same flash,
   decode and matmul ops of the granite-moe-1b-a400m pair (16 q / 8 kv
   heads of 64, d_model 1024; its 49155-wide head, whose N is no whole
   number of 16-byte vectors, on simt), and the flash backward and
   forward at granite's training shape (8, 16 / 8 heads of 64, 512),
   causal bf16, checked and timed.  The same ops of the whisper-base pair
   (8 slots, max_len 448): its projections (M = 448 / 8, K and N 512 or
   2048), its tied head read transposed (448 / 8 x 512 x 51,865: the
   (51,865, 512) embedding handed as it lies, on wgmma / skinny, beside
   ``torch.addmm`` with the ``embed.T`` view), its causal self-attention
   at 448 rows, the cross op's flash at prefill (448 q rows over the
   1500 memory rows, non-causal, the memory padded to the kv block and
   masked by kv_len in the wrapper) and decode at each tick (8 slots over
   all 1500 rows of a transposed view of the (slots, 1500, 8, 64)
   region), and the encoder's non-causal flash at 1500 x 1500 (per
   admission; its projections are cuBLAS, as ``@`` in the reference);
   where the wrapper pads q, k and v to its blocks, no unaligned view
   reaches the kernel and the bf16 simt check is skipped.  Each flash row
   must run f32 on simt and bf16 on mma (``flash_plan``), and the bf16 flash
   times are summed per smollm-360m and zamba2-7b admission, the forward
   and the backward per training step, likewise.  Then llama-3.2-vision-
   11b's attention at 5o's shapes, in its legacy path's layouts
   (``check_vlm_kernels``): the causal self flash (8, 32 / 8 heads of
   128, 128 rows), the non-causal cross flash of 128 queries over the
   1601 vision rows (no multiple of the kv block: the wrapper pads k and
   v and masks the padding through kv_len), the decode kernel over a
   512-row self ring with mixed kv_len and over all 1601 cross rows, in
   the legacy cache's contiguous (B, Hkv, S, D); f32 (1e-4) and bf16
   (2^-7), timed in bf16 beside the plain version, SDPA and the bound,
   and summed per forward (40 + 8 flash) and per decode step (40 + 8).
   Then the training shapes of 5p-5s: ``mamba2_scan`` and ``wkv6`` under
   autograd (``check_train_scans``: zamba2-7b's (8, 512, 112, 64) with
   N = 64, the mamba2 config's (8, 512, 80, 64) with N = 128, rwkv6-7b's
   (8, 512, 64, 64); y against the sequential f32 recurrence at 2^-7,
   every input's gradient against autograd through the chunked form at
   2^-7 of its largest, one launch a call), and both flash kernels at
   the six new attention shapes (``check_train_attention``: zamba2's
   shared (8, 32/32, 512, 112) causal, whisper's encoder (1500 x 1500),
   self (448) and cross (448 over 1500), the vlm's self (8, 32/8, 512,
   128) and cross (512 over 1601); padded by the wrapper's rule, the
   backward against ``flash_bwd_ref`` at one bf16 ulp plus the f32
   bound), timed beside their plain versions, SDPA and the bounds;
5. the main paths, each with the launch counters set to 0 just before
   it and read just after.  Every served Program run goes through the
   executor's CUDA-graph runners (``graphed_runner``,
   ``graphed_prefill_runner``, ``graphed_decode_runner``,
   ``graphed_chunk_runner``): the first call of a shape eager, the
   second captured and replayed, later ones replayed; the counters count
   each replay's captured launches, so the exact counts below hold.
   Each serving phase (5a-5e, 5g-5j) must show a captured graph for its
   decode tick (a CNN tick's run; a prefill where two or more were made)
   and is then served again under ``executor.disable_graphs()``: the
   greedy streams (classes) must be identical, every logits row bitwise
   equal for smollm-360m and alexnet-owt (no cuBLAS on their paths) and
   granite-moe-1b-a400m, and within the teacher-forced replay's bound
   for zamba2-7b and rwkv6-7b (cuBLAS in the projections), with the largest difference and the
   first op that differs (one call rerun op by op, eagerly and through a
   captured graph, from the same state) printed; the graphed and eager
   served ms per call (mean and median) and the capture seconds print
   side by side, and every smollm-360m phase's graphed median tick must
   be below its eager one.  The matmul wrapper's per-path counters must
   show every decode tick (M = 8 slots) and every CNN FC layer on the
   skinny path, every admission and chunk (M = 512 rows a prompt) on
   wgmma, and no served call on simt but granite's head (``matmul_plan``
   of each op's shape); the flash wrappers' must show every flash
   launch of 5b-5e, 5g, 5j and the bf16 training steps of 5f and 5k,
   forward and backward, on mma, and the f32 smoke step's on simt:
   a. ``repro_torch.launch.serve`` serves 20 alexnet-owt images at full
      width with 8 slots; every class must equal the plain path's on
      the card (rows whose top-2 logit gap exceeds 1e-4), and each
      counter must equal ticks x ops of that kind; then one resnet18
      batch-8 forward, kernels against plain;
   b. ``repro_torch.launch.serve --arch smollm-360m`` at full width in
      bf16 (random weights from the seed), 8 slots, max_len 512, 16
      requests with prompt lengths drawn in 32-448, 32 new tokens each;
      then the same with ``--window 128``, whose rings wrap while
      decoding.  Every request must be served with no prefill
      recomputed, and the counters must be exactly flash = prefills x
      32, decode_attention = decode ticks x 32 and matmul = (prefills +
      ticks) x 225.  The calls are recorded and replayed through the
      plain path on the card, teacher-forced with the kernel path's
      tokens: each logits row must agree within ``LOGIT_TOL``, and the
      served token must equal the plain path's wherever the plain top-2
      gap exceeds twice the row's largest logit difference (no two
      logits can swap order there);
   c. the paged plan (``--paged --shared-prefix 256``, bf16, page 16):
      16 prompts of the shared 256-token prefix and a 32-256-token tail
      from the seed; admission shares the prefix pages, and the rings
      that pass 512 rows wrap onto shared pages, which fork.  Requires
      ``n_shared_pages > 0`` and ``n_cow_forks > 0``;
   d. int8 pages (``kv_quant="int8"``) under a 122-page pool, with tails
      of 224-256 tokens, so admission finds the pool exhausted and
      requeues at the head (``n_requeued > 0``) while every request is
      served;
   e. chunked prefill over the paged plan (``--chunk-size 128`` and a
      448-token prompt injected two ticks in): no tick starves a live
      slot and every prefill completes within ceil(length / 128) ticks of
      its slot assignment.
   In 5c-5e the counters must be exactly paged decode = ticks x 32,
   contiguous decode = 0, flash = (prefill + chunk calls) x 32, matmul =
   (prefill + chunk calls + ticks) x 225, and the teacher-forced plain
   replay (page-table syncs and COW copies replayed in order) holds the
   same logit and token rules as 5b; no serving path launches the
   backward kernel;
   f. ``repro_torch.launch.train --smoke`` takes one step of the smoke
      config as it is (head dim 16, f32, batch 2 x 64): one flash
      forward and one backward launch per layer, a finite loss, and the
      same step's loss and gradients through the kernels within 1e-4 of
      the plain path; then ``repro_torch.launch.train`` trains
      full-width smollm-360m in bf16
      (batch 8, seq 512, SyntheticLM seed 0, AdamW with the CLI's cosine
      schedule) through the compiled step (step 0 eager, step 1
      captured into a CUDA graph, steps 2-5 replayed) into a temporary
      checkpoint directory: per step exactly 64 flash forward launches
      (32 layers, each recomputed under remat) and 32 backward ones, no
      matmul or decode launch, every loss finite; the step-0 params and
      batch through the plain path on the card (loss within 1e-2
      relative, global gradient norm within 2%, each leaf's largest
      gradient difference within 10% of that leaf's largest gradient); a
      fresh trainer resumed from the last checkpoint at the saved step
      with params and optimizer state equal bit for bit; then four
      steps through the compiled step against four under
      ``executor.disable_graphs()`` from the same params and batches:
      every metric, the params and the optimizer state bit for bit;
      tokens/s, the graphed and eager step ms side by side, each
      with one more step under the profiler (device time by group, the
      device-busy share), and the peak memory allocated are printed;
   g. ``repro_torch.launch.serve --arch zamba2-7b`` at full width and
      depth in bf16 (81 mamba layers, d_model 3584, 112 SSM heads of 64,
      N = 64; 14 applications of the shared block, 32 heads of 112), 8
      slots, max_len 512, 8 prompts of 32-448 tokens, 32 new tokens each;
   h. the same with ``--arch rwkv6-7b`` (32 layers, d_model 4096, 64
      heads of 64).
   i. ``serve_cnn`` serves the same 20 alexnet-owt images off the
      SNOWFLAKE paper-faithful Program at batch 8 (``compile_program(...,
      hw=SNOWFLAKE, paper_faithful=True)`` handed to ``ServingEngine``):
      exactly ticks x 5 ``conv2d_strips`` launches, no ``conv2d_virtual``
      launch and ticks x 3 matmul launches; classes equal the plain
      path's as in 5a; img/s beside 5a's; then one resnet18 SNOWFLAKE
      paper-faithful batch-8 forward, kernels against plain, with exactly
      20 strip launches.
   j. ``repro_torch.launch.serve --arch granite-moe-1b-a400m`` at full
      width and depth in bf16 (24 layers, each an MoE layer of 32
      experts, top-8; 1.385 B parameters), 8 slots, max_len 512, 8
      prompts of 32-448 tokens, 32 new tokens each, as 5g: 97 matmul
      (96 projections, skinny in a tick and wgmma in an admission, and
      the head on simt) and 24 attention launches a call; the replay's
      bound from two plain replays that sum in other orders
      (``reordered_plain``) and its mean gate at twice their mean; the
      rows whose routing differs from the plain path's at some layer
      counted (an eager kernel-path replay records the served routing);
      every op held to its plain version on the same input, the expert
      dispatch bit for bit; the eager re-serve bitwise equal;
   k. ``repro_torch.launch.train --arch granite-moe-1b-a400m`` at full
      width and depth (bf16, batch 8 x 512, 8-bit AdamW moments)
      through the compiled step for three steps: 48 flash forward and
      24 backward launches a step, finite losses (each with 0.01 x the
      load-balance loss) and expert imbalance, step 0's loss and
      gradients against the plain path as 5f, and four compiled steps
      against four eager ones bit for bit.
   l. ``repro_torch.launch.serve --arch whisper-base`` at full width and
      depth in bf16 (6 encoder and 6 decoder layers, d_model 512, 8
      heads of 64, vocab 51,865, the head tied to the embedding,
      learned decoder positions), 8 slots, max_len 448 (Whisper's
      decoder context), 16 requests of 4-224 prompt tokens and 32 new
      tokens each, so every slot is re-admitted once, each request with
      its (1500, 512) stub encoder frames from the seed: the encoder
      runs once per admission and writes the slot's read-only memory
      regions in place; exactly 6 + 6 flash launches per admission
      (self, cross) plus 6 for the encoder, 6 + 6 decode launches per
      tick (self, cross) and 49 matmul launches per call, the head on
      skinny in a tick and wgmma in an admission, none on simt, and one
      matmul launch per call reading B transposed; the encoder's time
      per admission printed beside the tick and admission; the
      teacher-forced plain replay re-encodes every request's frames
      through the plain path into a fresh state (a slot that read
      another request's memory fails it) and holds each row to
      ``LOGIT_TOL``; the eager re-serve identical and bitwise equal;
   m. speculative decode on the observability plane: 5b's command
      (smollm-360m, bf16, 8 slots, max_len 512, the same 16 prompts, 32
      new tokens) with ``--spec-decode 4`` (self-draft, also
      ``--sample-ops 8 --dash-every 16``), ``--spec-decode 4 --draft
      smollm-360m`` (weights from seed 1: every burst rolls back) and
      ``--chunk-size 128 --spec-decode 3``, each with ``--metrics-out``
      and ``--flight-out`` in a temporary directory: n_spec_accepted >
      0, n_spec_rollbacks > 0, and chunks with no starved tick
      respectively; exact launches and paths from the recorded calls,
      cross-checked against the engine's counters (a draft and a
      target prefill per admission, one verify chunk call a tick over
      the live slots' whole 512-row buffers, max_k draft decode rounds,
      a sampled tick's decode Program twice, eagerly); every token a
      verify emitted the argmax of its row, each such row within
      ``LOGIT_TOL`` of a plain prefill of the request's prompt and
      stream, and each stream's first divergence from 5b's at a plain
      top-2 gap within ``LOGIT_TOL``; the JSON snapshot's counters equal
      to the engine's, every counter in the ``.prom`` text, the flight
      record replaying every stream, ``op_time_us`` for matmul and
      decode_attention; the self-draft run's streams and state hashes
      equal an unsampled run's; an eager re-serve identical, its
      verify, draft and prefill rows bitwise equal; spec tick, draft
      round and verify ms by width B, graphed and eager, acceptance,
      capture seconds, sampled op times and tok/s beside 5b's; then 5b's
      plain serve twice with a flight recorder and twice without,
      alternated (the plane's cost, as the mean tick ms);
   n. the schedule autotuner (``repro_torch.core.autotune``) on 5a's
      zero-copy alexnet-owt Program (``TPU_V5E``) and 5i's SNOWFLAKE
      paper-faithful one at batch 8, and 5b's smollm-360m decode Program
      (bf16, 8 slots, max_len 512, after 8 prefills), random weights from
      the seed: trace, calibrate, replay the best ``TUNE_TOP_K``
      candidates an op and the incumbent, pin the winners in a tuned
      cache file; every time on the device clock (``executor.
      device_times``), candidates with the same launches measured once.
      Per op, the incumbent's and winner's decisions and device us and
      the distinct launches measured; per Program, the measured-against-
      predicted error table before and after calibration.  A second pass
      over the cache reloaded from its file must make 0 measurements;
      every tuned op's replay is held to its plain version (f32 1e-4,
      bf16 2^-7).  With the cache active the three are served again
      through 5a's, 5i's and 5b's entry points at their bars (classes
      against the plain path, teacher-forced logits, exact launches,
      graphed = eager bit for bit), the tuned against the untuned
      graphed medians, then in turns (untuned, tuned, tuned, untuned),
      and the served decode Program is traced on both clocks;
   o. llama-3.2-vision-11b (``serve_vlm``) at full width and depth in
      bf16, the weights from the seed with the 8 cross gates drawn
      nonzero: the generate path (``forward(vision_embeds=,
      return_cache=True, cache_len=512)`` on 8 prompts of 128 tokens over
      a (8, 1601, 4096) stub vision input, then 16 ``decode_step``s),
      exactly 48 flash launches a forward and 48 decode launches a step,
      replayed through the plain path and held to a floor built as the
      family phases build theirs (two plain versions, the second's
      attention the library's fused bf16 one), the cache leaves at 2^-7
      (1 + |x|) plus twice the two plain versions' largest difference at
      the same slot and row of the layer, the cross path shown
      to reach the logits (the gates zeroed move them past the bound);
      then ``ServingEngine``, which falls back to the legacy loop with
      the reference's blockers, serving 8 requests of 4-32 prompt tokens
      and 32 new tokens on 8 slots, exactly 48 decode launches a
      ``decode_step`` and no flash, replayed teacher-forced through a
      plain engine; tok/s, the step ms and the phase's seconds printed;
   p-s. training the hybrid, ssm, audio and vlm families
      (``train_family``) in bf16 with 8-bit AdamW moments and remat from
      16 layers on: zamba2-7b at full width and depth (81 layers, 14
      shared-attention applications, 8 x 512 tokens), rwkv6-7b (32
      layers, 8 x 512), whisper-base (6 + 6 layers, 8 x 448 tokens over
      seeded (8, 1500, 512) frames, through ``runtime.Trainer`` with a
      data wrapper) and llama-3.2-vision-11b at full width and 20 of its
      40 layers (4 cross layers; 8 x 512 over seeded (8, 1601, 4096)
      vision rows, the cross gates at 0.5): step 0's loss and gradients
      through the kernels against the plain path on the card (5f's gates;
      for the recurrent two each limit at least twice the same distance
      between the plain path and a second plain version that rounds
      otherwise, ``rounded_plain``, and none past FLOOR_CAP; zamba2-7b's
      at full width and 7 layers, STEP0_DEPTH), then 4 graphed steps
      (eager, captured, replays), exactly
      ``family_launches`` a step (zamba2-7b: 162 mamba2_scan, 28 flash
      forward, 14 backward; rwkv6-7b: 64 wkv6; whisper-base: 18 and 18;
      the vlm: 44 and 24), every flash launch on mma, then 4 steps under
      ``disable_graphs()``: every metric, param and optimizer-state leaf
      bit for bit (``graphed_against_eager_steps``, as 5f and 5k);
      tokens/s, the step ms graphed and eager, the peak memory and the
      graphed step's device-time profile printed;
   t. the sharded steps (``sharded_phase``): NCCL initialised as a world
      of one (``init_process_group("nccl", store=HashStore(), ...,
      device_id=)``, never gloo) and a (1, 1) ("data", "model") mesh;
      under each of tp, fsdp and auto, 2 sharded train steps of
      smollm-360m at full width and depth (bf16, f32 moments, 8 x 512,
      SyntheticLM batches; every leaf a DTensor), each bit for bit
      against ``build_train_step`` run eagerly from the same params
      (loss, grad norm, lr, every param and moment leaf); one sharded
      prefill (8 x 512) and 8 sharded decode steps under each of tp,
      fsdp and auto, bit for bit against the legacy
      ``forward(return_cache)`` and ``decode_step``: tp and auto go
      through the split code (``parallel/split.py``) at a group of one,
      its counters read (tp: whole heads; auto's mixed plan at (1, 1)
      puts no weight on "model"), fsdp (its rows on "model") through the
      weight-gathered path, nothing counted; both ring collective
      matmuls at the group of one at smollm's w_up shape (4096 x 960 x
      2560, bf16) through the matmul kernel against the plain matmul at
      2^-7; exactly 3 x 2 x 64 + 3 x 2 x 32 flash forward, 3 x 2 x 32
      backward (all on mma), 3 x 8 x 32 decode and 2 matmul launches on
      the sharded paths; the NCCL init time, each step's ms beside the
      eager single-device step's and 5f's, the prefill and decode ms
      (the weight-gathered path less the split one, the split one less
      the legacy one), one fsdp prefill and decode step profiled and
      their memory; then ``destroy_process_group()``;
   u. the dry-run tooling (``dryrun_phase``), no kernel, after 5t:
      5t's own cell counted by ``core/step_analysis.py::analyze_step``
      on a fake world of one, its FLOPs within FLOP_COUNT_TOL of
      ``plain_train_flops`` (6ND, the remat forward, the attention) and,
      at the bf16 peak, at or under 5t's profiled device time; its bound
      max(FLOPs / the bf16 peak, HBM bytes / the HBM rate) printed beside
      5t's measured steps; then ``python -m repro_torch.launch.dryrun
      --arch smollm-360m`` once a cell, the four processes at once:
      train_4k, prefill_32k, decode_32k on 16x16 and train_4k on
      2x16x16 (a fake world of 512 ranks, fake tensors, the CPU), every
      record error-free with FLOPs, and ``python -m
      repro_torch.launch.report`` over them rendering a row for each in
      both tables;
   v. the split prefill and decode (``split_phase``), after 5u, in a
      subprocess (``split_child``): a fake process group of 5 ranks on
      the card (``launch/dryrun.fake_world``; all_reduce, all_gather and
      all_to_all_single first tried on CUDA tensors) and a (1, 5)
      ("data", "model") mesh; rank 0's blocks of seeded full-width
      smollm-360m (32 layers, bf16; 5 divides its 15 / 5 heads) under tp
      and auto: one prefill of 8 x 512 and 8 decode steps on its cache,
      every flash launch at (8, 3/1, 512, 64) and decode launch at (8
      slots, 3/1 x 64, cache 512) held to its plain version on the same
      inputs at 2^-7, exactly 32 flash and 256 decode launches and the
      split's counters a strategy; rank 0's prefill and decode ms,
      device ms and memory beside 5t's; then the split train step under
      tp and auto (4 steps of 8 x 512), every flash forward launch held
      at 2^-7 and every backward launch at one bf16 ulp plus the f32
      bound of its sums, exactly 64 forward and 32 backward launches and
      only all-reduces a step, timed, profiled and its memory read; and
      one launch of each kernel at the shard shapes timed against its
      plain version, SDPA and its bound (the collectives move nothing,
      so outputs are held on gloo ranks by the CPU tests, not here);
   5b, 5g, 5h and 5l each end with a legacy leg (``legacy_leg``): the
   phase's first 8 prompts, cut to the shortest, through the phase's
   Program pair and 8 greedy ticks, then through the legacy ``forward
   (return_cache)`` and 8 ``decode_step``s fed the pair's tokens, every
   logits row held to the pair's under the phase's gate, with exactly
   the attention, cross and scan launches the pair's listing makes a
   layer and no matmul launch.
   In 5g and 5h the counters must be exactly the Program's kernel ops per
   call (``PAIR_OPS``: zamba2-7b 81 mamba2_scan and 99 matmul per
   admission and per tick, 14 flash per admission, 14 decode per tick;
   rwkv6-7b 32 wkv6 per admission, none per tick -- its decode step is
   plain torch, as in the reference -- and 1 matmul per call) times the
   calls, and the teacher-forced plain replay holds each logits row
   within max(0.25, twice the largest difference between two plain
   replays that differ only in the recurrence's summation order: the
   chunked form and the sequential f32 oracle), the mean |logit diff|
   over the rows within a fixed limit (0.28 zamba2-7b, 0.08 rwkv6-7b:
   twice the two plain replays' mean on an H100) and the tokens as in
   5b; then every admission before the first decode tick and that tick
   again, op by op: each matmul, attention and recurrent-block op
   through the kernel path and through the plain path (the recurrence as
   its sequential f32 oracle) on the plain path's input, the outputs
   held at the bf16 rule (2^-7; a recurrent block's output, which feeds
   its kernel's y through a gated norm and a wide projection, at 2^-7 of
   its largest magnitude) and the recurrent states each block writes at
   1e-4; the weights' parameter count, the persistent state
   by kind and the peak memory are printed;
6. the served ms per Program run, graphed against eager, beside each
   run's kernel sum and the device-busy share (kernel sum over the
   graphed median); then a ``kernels`` JSON line: per kernel, its
   launches on the main paths, the max error over every checked op,
   and the times and bound summed
   over one alexnet-owt batch-8 tick (conv2d_virtual), one SNOWFLAKE
   paper-faithful alexnet-owt batch-8 tick (conv2d_strips), one smollm-360m
   admission (flash_attention), one smollm-360m decode tick
   (decode_attention, paged_decode_attention, matmul), one smollm-360m
   training step (flash_attention_bwd), one zamba2-7b admission
   (mamba2_scan) or one rwkv6-7b admission (wkv6); the granite rows
   (per tick, per admission, the head, per training step) and the
   kernels per training step of 5p-5s (phase 4's training rows times
   their launches a step) print before it;
7. the last line: ``{"ok": true, "device": {...}}``.

TF32 is switched off for cuDNN and cuBLAS, so the plain versions and
the library yardsticks compute in full f32 like the kernels.  Inputs are
not flushed from the 50 MB L2 between timed calls.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-4
BF16_TOL = 2.0 ** -7
SLOTS, REQUESTS, SEED = 8, 20, 0
# The CNN phases serve their images this many times more on each engine
# (graphed and eager), so their tick times are read over replays.
CNN_REPEATS = 4
LM_ARCH, LM_MAX_LEN, LM_WINDOW = "smollm-360m", 512, 128
LM_ARGS = ["--arch", LM_ARCH, "--slots", str(SLOTS), "--max-len",
           str(LM_MAX_LEN), "--requests", "16", "--prompt-len", "32-448",
           "--max-new", "32", "--seed", str(SEED)]
# Logit agreement of the served bf16 streams with the plain path: both
# round every activation to bf16, but sum in other orders, so a value
# may round to a neighbouring bf16 (2^-8 relative) at any of the ~10
# roundings per layer, and the differences compound over 32 layers into
# logits of magnitude ~4 (random weights, unit-variance head).
LOGIT_TOL = 0.25
# The recurrent families' serving phases (5g zamba2-7b, 5h rwkv6-7b): full
# width and depth, bf16, 8 slots, max_len 512, 8 prompts of 32-448 tokens,
# 32 new tokens each.  Their replay bound is the larger of smollm's 0.25
# and twice the largest difference between two plain replays of the same
# calls that differ only in the recurrence's summation order (its chunked
# form against its sequential f32 oracle, ``FAMILY_FLOOR``).  Random-weight
# zamba2-7b (95 blocks) and rwkv6-7b (32) amplify one-ulp differences with
# depth: two plain replays of the same calls differ by up to 1.2 and 0.3
# in logits of magnitude ~5 (this script, on an H100 80GB HBM3).  No fixed
# bound on the largest difference separates that from a fault's O(1)
# error, so that floor is measured on the same calls.  Two checks do not
# move with the run: the mean |logit diff| over the rows must stay within
# ``FAMILY_MEAN_TOL``, twice the mean between the two plain replays
# (0.1419 and 0.0387 on that card; the served paths read 0.1929 and
# 0.0395), and every op of the served Program is held to its plain
# version on the same input (``check_family_ops``).
FAMILY_ARGS = ["--slots", str(SLOTS), "--max-len", str(LM_MAX_LEN),
               "--requests", "8", "--prompt-len", "32-448", "--max-new",
               "32", "--seed", str(SEED)]
FAMILY_FLOOR = {"zamba2-7b": ("zamba2", "mamba2_scan"),
                "rwkv6-7b": ("rwkv", "wkv6")}
FAMILY_MEAN_TOL = {"zamba2-7b": 0.28, "rwkv6-7b": 0.08}
# granite-moe-1b-a400m (hf:ibm-granite/granite-3.0-1b-a400m-base) at full
# width and depth in bf16: 5j serves it off the graphed pair (FAMILY_ARGS),
# 5k trains it through the compiled step for MOE_STEPS steps.  A bf16
# difference of one ulp can flip a near-tie of its top-8 routing between
# two paths, which moves a token to another expert, so its replay gate is
# built like the recurrent families': the max bound is max(LOGIT_TOL, twice
# the largest difference between two plain replays that differ only in
# summation order, ``reordered_plain``), the mean |logit diff|
# is held to twice those two replays' mean, the same run's, and every op
# is held to its plain version on the same input (``check_family_ops``;
# the dispatch, plain torch on both sides, bit for bit).
MOE_ARCH, MOE_STEPS = "granite-moe-1b-a400m", 3
# llama-3.2-vision-11b (hf:meta-llama/Llama-3.2-11B-Vision) at full width
# and depth in bf16 (5o): 40 layers, d_model 4096, 32 / 8 heads of 128, a
# gated cross-attention block before every 5th layer over 1601 vision
# rows.  It has no Program lowering, so it runs the legacy path: the
# generate path on VLM_BATCH prompts of VLM_PROMPT tokens with a
# (VLM_BATCH, 1601, 4096) stub vision input and a cache of LM_MAX_LEN
# rows, VLM_STEPS decode steps; then the engine, which falls back to the
# legacy loop, on VLM_ARGS' requests (no vision input, as in the
# reference).
VLM_ARCH, VLM_PROMPT, VLM_STEPS = "llama-3.2-vision-11b", 128, 16
VLM_REQUESTS, VLM_PROMPT_LEN, VLM_NEW = 8, (4, 32), 32
# The legacy legs of 5b, 5g, 5h and 5l: the phase's first SLOTS prompts,
# cut to the shortest of them, through the phase's Program pair (its
# emitted tokens) and through the legacy forward and LEGACY_STEPS
# decode steps fed those tokens.
LEGACY_STEPS = 8
# whisper-base (arXiv:2212.04356) at full width and depth in bf16 (6
# encoder and 6 decoder layers, d_model 512, 8 heads of 64, vocab 51,865,
# the head tied to the embedding): 5l serves 16 requests on 8 slots at
# Whisper's own decoder context of 448 tokens, so every slot is
# re-admitted once, each request with its (1500, 512) stub encoder
# frames drawn from the seed (the audio frontend is a stub, as in the
# reference).
WHISPER, WHISPER_MAX_LEN = "whisper-base", 448
WHISPER_ARGS = ["--arch", WHISPER, "--slots", str(SLOTS), "--max-len",
                str(WHISPER_MAX_LEN), "--requests", "16", "--prompt-len",
                "4-224", "--max-new", "32", "--seed", str(SEED)]
# Kernel-launching ops per (prefill, decode) Program of each served pair,
# read off the Program listings; the exact launch counts multiply them.
# rwkv6's decode step is plain torch (no wkv6 launch), as in the reference.
PAIR_OPS = {
    LM_ARCH: ({"matmul": 225, "flash_attention": 32},
              {"matmul": 225, "decode_attention": 32}),
    "zamba2-7b": ({"matmul": 99, "flash_attention": 14, "ssm_scan": 81},
                  {"matmul": 99, "decode_attention": 14, "ssm_scan": 81}),
    "rwkv6-7b": ({"matmul": 1, "wkv": 32}, {"matmul": 1, "wkv": 32}),
    MOE_ARCH: ({"matmul": 97, "flash_attention": 24},
               {"matmul": 97, "decode_attention": 24}),
    WHISPER: ({"matmul": 49, "flash_attention": 6, "cross_attention": 6},
              {"matmul": 49, "decode_attention": 6, "cross_attention": 6})}
KERNEL_OPS = ("matmul", "flash_attention", "decode_attention", "ssm_scan",
              "wkv", "cross_attention")
# Peak operation rates by operand type and the HBM rate, by card name:
# NVIDIA's data sheet for the H100 SXM part at 700 W (f32 outside the
# tensor cores, bf16 dense tensor cores).  Another card has no entry
# here and the script stops rather than bound it by a wrong peak.
PEAKS = {"NVIDIA H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12,
                                   "tfloat32": 495e12, "hbm": 3.35e12}}
REPLACES = {"conv2d_virtual": "src/repro/kernels/conv2d/kernel.py:241",
            "conv2d_strips": "src/repro/kernels/conv2d/kernel.py:111",
            "matmul": "src/repro/kernels/matmul/kernel.py:79",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:88",
            "flash_attention_bwd":
                "src/repro/kernels/flash_attention/bwd_kernel.py:134",
            "decode_attention":
                "src/repro/kernels/decode_attention/kernel.py:76",
            "paged_decode_attention":
                "src/repro/kernels/decode_attention/kernel.py:175",
            "mamba2_scan": "src/repro/kernels/mamba2/kernel.py:78",
            "wkv6": "src/repro/kernels/rwkv6/kernel.py:58"}
SOURCES = {"conv2d_virtual": "src/repro_torch/kernels/csrc/conv2d.cu",
           "conv2d_strips": "src/repro_torch/kernels/csrc/conv2d_strips.cu",
           "matmul": "src/repro_torch/kernels/csrc/matmul.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_bwd":
               "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "decode_attention":
               "src/repro_torch/kernels/csrc/decode_attention.cu",
           "paged_decode_attention":
               "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
           "mamba2_scan": "src/repro_torch/kernels/csrc/mamba2_scan.cu",
           "wkv6": "src/repro_torch/kernels/csrc/wkv6.cu"}
# The paged serving phases (5c, 5e): the serve CLI's flags after LM_ARGS
# (a later --prompt-len wins).  5d has no CLI flag for the pool size, so
# it calls serve_lm with these arguments; its tails and pool are the
# seed's draw checked to exhaust the pool at admission without running
# it dry mid-decode (admission reserves no decode pages, as in the
# reference).
PAGE_SIZE, N_PAGES, PREFIX = 16, 257, 256
PAGED_RUNS = {
    "5c paged": ["--paged", "--shared-prefix", str(PREFIX),
                 "--prompt-len", "32-256"],
    "5e chunked": ["--paged", "--chunk-size", "128", "--shared-prefix",
                   str(PREFIX), "--long-prompt", "448", "--prompt-len",
                   "32-256"]}
PAGED_5D = dict(paged=True, shared_prefix=PREFIX, prompt_len=(224, 256),
                kv_quant="int8", page_pool=122)
# The training path (phase 5f): full-width smollm-360m in bf16, batch 8,
# seq 512, one warm-up step and five timed ones.  The backward kernel is
# checked at the same attention shape (B, 15 q / 5 kv heads of 64, 512),
# causal, windowed and kv_len-masked; the autograd comparison at batch 2.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 6
# The compiled step against the eager one (5f, 5k): this many steps each
# way from the same params and batches, two of them replays.
COMPARE_STEPS = 4
# Step-0 agreement of the kernel path with the plain path on the card,
# both bf16: attention outputs and gradients are each rounded once to
# bf16 on both sides but summed in other orders, so they differ by about
# one bf16 ulp per layer, which the loss averages and the global norm
# sums over 360M gradients.
LOSS_RTOL, GNORM_RTOL = 1e-2, 0.02
# Each leaf's largest gradient difference over that leaf's largest
# gradient: sound runs read 2.9% at most (wk; H100 80GB HBM3), while a fault
# confined to one leaf's gradient (a mis-strided dq) moves it to ~100%.
LEAF_RTOL = 0.10
# No leaf limit raised by a plain floor (``step0_against_plain``) may pass
# this: a lost or zeroed gradient reads 1.0, and must fail.
FLOOR_CAP = 0.5
# The backward's bf16 check: one ulp of the plain result plus, for the
# sums that cancel, the f32 rounding bound of the plain computation: the
# unit roundoff 2^-24 times its longest chain of sums (Skv keys after D
# products), times each element's sum of absolute terms.  Both sides sum
# the same f32 terms (the mma path splits P and dS into bf16 parts that
# sum to them exactly) and round once to bf16, but in another order;
# where a sum cancels, two orders differ by more than an ulp of the
# result (the plain version against itself with 64-key chunks does, on
# the card).
def bwd_slack(Skv: int, D: int) -> float:
    return (Skv + D) * 2.0 ** -24


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def reset_matmul_paths() -> None:
    """Set the matmul wrapper's per-path launch counts to 0."""
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    for path in matmul_cuda.path_launches:
        matmul_cuda.path_launches[path] = 0


def check_matmul_paths(label: str, skinny: int, wgmma: int,
                       simt: int = 0) -> None:
    """The matmul launches since the last reset went exactly ``skinny``
    times through the skinny path, ``wgmma`` times through wgmma and
    ``simt`` times through simt."""
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    got = dict(matmul_cuda.path_launches)
    want = {"skinny": skinny, "wgmma": wgmma, "simt": simt}
    print(f"{label}: matmul paths {got}, want {want}")
    if got != want:
        fail(f"{label}: matmul paths {got} != {want}")


def matmul_paths(cfg, prog, M: int) -> Counter:
    """``matmul_plan``'s path of each matmul op of ``prog`` at M rows, in
    the config's type, counted; a tied bf16 head reads its weight
    transposed (``ops.matmul`` copies an f32 one)."""
    import torch
    from repro_torch.kernels.matmul.kernel import matmul_plan
    from repro_torch.models import param_defs
    defs = param_defs(cfg)
    bf16 = cfg.tdtype == torch.bfloat16
    return Counter(matmul_plan(M, *_weight_shape(defs, op.param_key)
                               [::-1 if op.transpose_w else 1],
                               cfg.tdtype,
                               b_transposed=op.transpose_w and bf16).path
                   for op in prog.ops if op.kernel == "matmul")


def reset_flash_paths() -> None:
    """Set the flash wrappers' per-path launch counts to 0."""
    for fn in flash_wrappers():
        for path in fn.path_launches:
            fn.path_launches[path] = 0


def flash_wrappers():
    from repro_torch.kernels.flash_attention.bwd_kernel import (
        flash_attention_bwd_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    return flash_attention_cuda, flash_attention_bwd_cuda


def flash_paths() -> list:
    """The flash wrappers' per-path launch counts since the last reset:
    [forward, backward]."""
    return [dict(fn.path_launches) for fn in flash_wrappers()]


def check_flash_paths(label: str, fwd: int, bwd: int,
                      path: str = "mma", got=None) -> None:
    """The flash launches since the last reset (or ``got``, counts taken
    earlier by ``flash_paths``) went ``fwd`` (forward) and ``bwd``
    (backward) times through ``path`` and never through the other
    one."""
    got = flash_paths() if got is None else got
    want = [{"mma": 0, "simt": 0, path: n} for n in (fwd, bwd)]
    print(f"{label}: flash paths forward {got[0]}, backward {got[1]}; "
          f"want {want[0]}, {want[1]}")
    if got != want:
        fail(f"{label}: flash paths {got} != {want}")


def kernel_name(line: str) -> str:
    """``name<template args>`` of the kernel a ptxas "Compiling entry
    function '<mangled>'" line names: the mangled name's ``<len><name>``
    ending in ``_kernel`` and its template arguments as mangled."""
    m = re.search(r"(\w*?_kernel)(I\w*?E)?E", line)
    if not m:
        return "?"
    head = m.group(1)
    for i in range(len(head) - 1, 0, -1):
        if head[:i].endswith(str(len(head) - i)) and not head[i].isdigit():
            return f"{head[i:]}<{(m.group(2) or 'I E')[1:-1]}>"
    return head


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()`` call, in ms: ``executor.device_times``
    (``reps`` calls captured into one CUDA graph after ``warmup`` eager
    calls, the graph replayed five times between CUDA events), the
    median replay over ``reps``.  The graph keeps the host's launch
    latency out of the reading, so a kernel shorter than its Python
    wrapper is timed, not the wrapper."""
    import torch
    from repro_torch.runtime.executor import device_times
    dev = torch.device("cuda", torch.cuda.current_device())
    return 1e3 * statistics.median(device_times(fn, reps, 5, dev,
                                                warmup=warmup))


def max_err(got, want, tol: float = TOL) -> float:
    """max |got - want|; fails unless every element is within atol = rtol
    = ``tol`` and finite."""
    import torch
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"kernel output {tuple(got.shape)} not finite or not "
             f"{tuple(want.shape)}")
    err = (got - want).abs()
    if not bool((err <= tol + tol * want.abs()).all()):
        fail(f"kernel disagrees with its plain version: max |err| "
             f"{err.max().item():.3e} (tolerance {tol:.3e})")
    return err.max().item()


def bf16_ulp(want):
    """The spacing of bf16 at |want| (at least that of the smallest
    normal), elementwise."""
    import torch
    tiny = torch.finfo(torch.bfloat16).tiny
    _, e = torch.frexp(want.float().abs().clamp_min(tiny))
    return torch.ldexp(torch.ones_like(want.float()), e - 8)


def past_ulp(got, want, slack):
    """(elements of ``got`` past one bf16 ulp of ``want``, the largest
    excess past that ulp over ``slack``, elementwise): how much of the
    f32 part of ``max_err_ulp``'s tolerance the elements use."""
    import torch
    err = (got.float() - want.float()).abs()
    over = err - bf16_ulp(want)
    excess = torch.where(over > 0, over / slack, torch.zeros_like(over))
    return int((over > 0).sum()), excess.max().item()


def unaligned(t):
    """``t`` (a (B, H, S, D) view of a (B, S, H, D) buffer) copied into a
    buffer that starts 2 bytes past a 16-byte boundary: the same values
    and layout, which the flash kernels' mma path cannot load in 16-byte
    vectors, so they run on simt."""
    import torch
    B, H, S, D = t.shape
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(B, S, H, D).transpose(1, 2)
    view.copy_(t)
    return view


def max_err_ulp(got, want, slack=None) -> tuple[float, float]:
    """(max |got - want|, the largest |got - want| over its tolerance) of
    two bf16 tensors; fails unless every element
    of ``got`` is finite and within one bf16 ulp of ``want`` (the spacing
    of bf16 at |want|, at least that of the smallest normal), plus
    ``slack`` (elementwise) where given.  Two f32 sums of the same terms
    differ by at most the f32 rounding error of the terms' absolute sum,
    and once rounded to bf16 by one ulp more: ``slack`` is that f32 bound
    where the rounding error can exceed an ulp (sums that cancel)."""
    import torch
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"kernel output {tuple(got.shape)} not finite or not "
             f"{tuple(want.shape)}")
    tol = bf16_ulp(want) + (0.0 if slack is None else slack)
    err = (got - want).abs()
    worst = (err / tol).max().item()
    if not worst <= 1.0:
        fail(f"kernel disagrees with its plain version by {worst:.2f} times "
             f"its tolerance (max |err| {err.max().item():.3e}; tolerance "
             f"one bf16 ulp{'' if slack is None else ' + the f32 bound'})")
    return err.max().item(), worst


def op_cases(cfg, batch, device, hw=None, paper_faithful=False):
    """Walk the Program (compiled for ``hw``, the default TPU_V5E when
    None) on the plain path; yield each conv / matmul op with the
    operands the executor hands it."""
    import torch
    from repro_torch.core import TPU_V5E
    from repro_torch.models import cnn, init_params
    from repro_torch.runtime.executor import walk
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(cnn.param_defs(cfg), gen, device)
    program = cnn.compile_program(cfg, batch=batch, hw=hw or TPU_V5E,
                                  paper_faithful=paper_faithful)
    x = torch.randn((batch, cfg.input_hw, cfg.input_hw, cfg.input_ch),
                    generator=gen, device=device)
    for op, src, p, byp in walk(program, params, x, impl="reference"):
        if op.kernel in ("conv2d", "matmul"):
            yield op, src, p, byp


def cudnn_conv(op, x, w, bias, byp, stride: int, pad: int, pool):
    """The library yardstick of a conv kernel: cuDNN ``F.conv2d`` on the
    whole NHWC maps (read as channels_last) with the same epilogue, then
    ``pool`` when the kernel fuses one."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.common import apply_activation
    from repro_torch.kernels.conv2d.kernel import pool_ref
    w_lib = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    x_lib = x.permute(0, 3, 1, 2)            # NHWC data as channels_last
    byp_lib = None if byp is None else byp.permute(0, 3, 1, 2)

    def library():
        out = F.conv2d(x_lib, w_lib, bias, stride, pad)
        if byp_lib is not None and op.bypass_first:
            out = out + byp_lib
        out = apply_activation(out, op.fuse_activation)
        if byp_lib is not None and not op.bypass_first:
            out = out + byp_lib
        if pool is not None:
            out = pool_ref(out.permute(0, 2, 3, 1), pool)
        return out
    return library


def conv_plan_text(g, *operands) -> str:
    """``conv_plan``'s launch of geometry ``g`` on these operands: pixel
    tile, splits, CTAs and, with a fused pool, the pooled tile."""
    from repro_torch.kernels.conv2d.kernel import conv_plan
    plan = conv_plan(g, aligned=all(t.data_ptr() % 16 == 0
                                    for t in operands))
    pool = (f" pooled {plan.tile_r}x{plan.tile_c} (conv {plan.conv_r}x"
            f"{plan.conv_c})" if plan.tile_r else "")
    return (f"plan: {plan.bm}-pixel tiles, {plan.splits} splits of "
            f"{plan.kps}/{plan.k_slices} slices, {plan.ctas} CTAs{pool}")


def conv_case(op, x, p, byp):
    from repro_torch.kernels.conv2d.kernel import (conv2d_virtual_cuda,
                                                   conv2d_virtual_plain)
    from repro_torch.kernels.conv2d.ops import norm_pool, virtual_plan
    g, dataflow, _ = virtual_plan(
        tuple(x.shape), tuple(p["w"].shape), stride=op.stride, pad=op.pad,
        pool=norm_pool(op.fuse_pool), has_bypass=byp is not None,
        tiling=op.conv_tiling, dataflow=op.dataflow)
    kw = dict(bias=p["b"] if op.fuse_bias else None,
              activation=op.fuse_activation, bypass=byp,
              bypass_first=op.bypass_first)
    x = x.contiguous()
    kern = lambda: conv2d_virtual_cuda(x, p["w"], g, dataflow=dataflow, **kw)
    plain = lambda: conv2d_virtual_plain(x, p["w"], g, **kw)
    library = cudnn_conv(op, x, p["w"], kw["bias"], byp, g.stride, g.pad,
                         g.pool)
    err = max_err(kern(), plain())
    flops = 2 * g.B * g.OH * g.OW * g.Cout * g.kh * g.kw * g.Cin
    nbytes = 4 * (x.numel() + p["w"].numel() + g.Cout
                  + g.B * g.OHo * g.OWo * g.Cout
                  + (0 if byp is None else byp.numel()))
    return "conv2d_virtual", err, kern, plain, library, flops, nbytes, (
        f"{tuple(x.shape)}*{tuple(p['w'].shape)} s{g.stride} p{g.pad} "
        f"rows={g.out_rows} kpt={g.kpt} pool={g.pool} "
        f"bypass={byp is not None} {dataflow.name}; "
        f"{conv_plan_text(g, x, p['w'])}")


def strips_case(op, x, p, byp):
    """A materialized conv: the strip copy, then the strips kernel against
    its plain version on the same strips; the library yardstick is cuDNN
    on the whole maps (no pool: a requested one runs after the kernel as
    its own op).  Returns conv_case's tuple plus the copy's thunk and the
    byte counts it prints."""
    from repro_torch.core.dataflow import Dataflow, conv_strip_traffic
    from repro_torch.kernels.conv2d.kernel import (conv2d_strips_cuda,
                                                   conv2d_strips_plain,
                                                   materialize_strips,
                                                   strip_bypass)
    from repro_torch.kernels.conv2d.ops import strips_plan
    g, dataflow = strips_plan(tuple(x.shape), tuple(p["w"].shape),
                              stride=op.stride, pad=op.pad,
                              tiling=op.conv_tiling, dataflow=op.dataflow)
    x = x.contiguous()
    strips = materialize_strips(x, g)
    sbyp = None if byp is None else strip_bypass(byp, g)
    kw = dict(bias=p["b"] if op.fuse_bias else None,
              activation=op.fuse_activation, bypass=sbyp,
              bypass_first=op.bypass_first)
    kern = lambda: conv2d_strips_cuda(strips, p["w"], g, dataflow=dataflow,
                                      **kw)
    plain = lambda: conv2d_strips_plain(strips, p["w"], g, **kw)
    copy = lambda: materialize_strips(x, g)
    library = cudnn_conv(op, x, p["w"], kw["bias"], byp, g.stride, g.pad,
                         None)
    err = max_err(kern(), plain())
    flops = 2 * g.B * g.OH * g.OW * g.Cout * g.kh * g.kw * g.Cin
    out_el = g.B * g.OH * g.OW * g.Cout
    nbytes = 4 * (strips.numel() + p["w"].numel() + g.Cout + out_el
                  + (0 if byp is None else out_el))
    kloop, mloop = conv_strip_traffic(
        4 * x.numel(), 4 * p["w"].numel(), 4 * out_el, n_map_tiles=g.NS,
        n_kernel_tiles=g.Cout // g.kpt,
        overlap_frac=op.conv_tiling.overlap_frac,
        strip_storage="materialized")
    traffic = {"maps_bytes": 4 * x.numel(),
               "strip_bytes": 4 * strips.numel(),
               "modeled_bytes": (mloop if dataflow is Dataflow.WEIGHTS_RESIDENT
                                 else kloop)}
    return "conv2d_strips", err, kern, plain, library, flops, nbytes, (
        f"{tuple(x.shape)}*{tuple(p['w'].shape)} s{g.stride} p{g.pad} "
        f"rows={g.out_rows} kpt={g.kpt} strips={tuple(strips.shape)} "
        f"bypass={byp is not None} {dataflow.name}; "
        f"{conv_plan_text(g, strips, p['w'])}"), copy, traffic


def matmul_case(op, x, p, byp):
    import torch
    from repro_torch.kernels.common import apply_activation
    from repro_torch.kernels.matmul.kernel import (matmul_cuda,
                                                   matmul_plain, matmul_plan)
    a = x.reshape(x.shape[0], -1).contiguous()
    w = p["w"]
    M, K = a.shape
    N = w.shape[1]
    block = tuple(min(v, -(-d // 128) * 128) for v, d in
                  zip(op.block, (M, K, N)))
    bias = p["b"] if op.fuse_bias else None
    kw = dict(bias=bias, activation=op.fuse_activation, bypass=byp)
    kern = lambda: matmul_cuda(a, w, dataflow=op.dataflow, block=block, **kw)
    plain = lambda: matmul_plain(a, w, **kw)

    def library():
        out = torch.addmm(bias, a, w) if bias is not None else a @ w
        return apply_activation(out, op.fuse_activation)

    err = max_err(kern(), plain())
    flops = 2 * M * N * K
    nbytes = 4 * (M * K + K * N + M * N + (0 if bias is None else N))
    path = matmul_plan(M, K, N, a.dtype).path
    return "matmul", err, kern, plain, library, flops, nbytes, (
        f"{M}x{K}x{N} block={block} {op.dataflow.name} path={path}")


# Phase 3's Programs: (label, arch, hardware model name, paper_faithful).
# "@snowflake" labels the SNOWFLAKE paper-faithful Program, every conv of
# which runs on materialized strips.
PHASE3_PROGRAMS = (("alexnet-owt", "alexnet-owt", None, False),
                   ("resnet18", "resnet18", None, False),
                   ("alexnet-owt@snowflake", "alexnet-owt", "SNOWFLAKE",
                    True),
                   ("resnet18@snowflake", "resnet18", "SNOWFLAKE", True))


def check_kernels(device, peaks):
    """Phase 3; returns the per-op rows (f32).  ``uses`` counts the ops of
    the row's Program that share its shape (timed once)."""
    from repro_torch import core
    from repro_torch.configs import CNN_REGISTRY
    rows, seen = [], {}
    for label, arch, hw, faithful in PHASE3_PROGRAMS:
        for op, x, p, byp in op_cases(
                CNN_REGISTRY[arch], SLOTS, device,
                hw=getattr(core, hw) if hw else None,
                paper_faithful=faithful):
            extra = None
            if op.kernel != "conv2d":
                case = matmul_case(op, x, p, byp)
            elif op.strip_storage == "materialized":
                *case, copy, traffic = strips_case(op, x, p, byp)
                extra = (copy, traffic)
            else:
                case = conv_case(op, x, p, byp)
            name, err, kern, plain, library, flops, nbytes, desc = case
            if (label, desc) in seen:
                seen[(label, desc)]["uses"] += 1
                continue
            row = {"arch": label, "op": op.name, "kernel": name,
                   "shape": desc, "max_abs_err": err, "uses": 1,
                   "ms": time_ms(kern), "plain_ms": time_ms(plain),
                   "library_ms": time_ms(library),
                   "flop_ms": flops / peaks["float32"] * 1e3,
                   "byte_ms": nbytes / peaks["hbm"] * 1e3}
            row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
            seen[(label, desc)] = row
            rows.append(row)
            more = ""
            if extra is not None:
                copy, traffic = extra
                row.update(traffic, copy_ms=time_ms(copy))
                more = (f" copy={row['copy_ms']:.4f} maps="
                        f"{traffic['maps_bytes'] / 1e6:.3f}MB strips="
                        f"{traffic['strip_bytes'] / 1e6:.3f}MB modeled="
                        f"{traffic['modeled_bytes'] / 1e6:.3f}MB")
            print(f"  {label:21s} {op.name:7s} {name:14s} err={err:.2e} "
                  f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
                  f"lib={row['library_ms']:.4f} bound={row['bound_ms']:.4f}"
                  f"{more} | {desc}", flush=True)
    return rows


def check_bf16_convs(device):
    """Phase 3's bf16 check: every conv of the alexnet-owt zero-copy and
    SNOWFLAKE paper-faithful Programs again with its maps, weights, bias
    and bypass in bf16, through the kernel (exact bf16 products, f32 sums,
    one rounding) against its plain version (f32 sums, one rounding), at
    atol = rtol = 2^-7.  Not timed.  Returns rows of (kernel, arch,
    max_abs_err)."""
    import torch
    from repro_torch.core import SNOWFLAKE
    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.kernels.conv2d.kernel import (
        conv2d_strips_cuda, conv2d_strips_plain, conv2d_virtual_cuda,
        conv2d_virtual_plain, materialize_strips, strip_bypass)
    from repro_torch.kernels.conv2d.ops import (norm_pool, strips_plan,
                                                virtual_plan)
    bf = torch.bfloat16
    rows = []
    for label, hw, faithful in (("alexnet-owt", None, False),
                                ("alexnet-owt@snowflake", SNOWFLAKE, True)):
        for op, x, p, byp in op_cases(CNN_REGISTRY["alexnet-owt"], SLOTS,
                                      device, hw=hw,
                                      paper_faithful=faithful):
            if op.kernel != "conv2d":
                continue
            xb, w = x.contiguous().to(bf), p["w"].to(bf)
            yb = None if byp is None else byp.to(bf)
            kw = dict(bias=p["b"].to(bf) if op.fuse_bias else None,
                      activation=op.fuse_activation,
                      bypass_first=op.bypass_first)
            if op.strip_storage == "materialized":
                g, dataflow = strips_plan(
                    tuple(x.shape), tuple(w.shape), stride=op.stride,
                    pad=op.pad, tiling=op.conv_tiling, dataflow=op.dataflow)
                strips = materialize_strips(xb, g)
                sbyp = None if yb is None else strip_bypass(yb, g)
                name = "conv2d_strips"
                got = conv2d_strips_cuda(strips, w, g, dataflow=dataflow,
                                         bypass=sbyp, **kw)
                want = conv2d_strips_plain(strips, w, g, bypass=sbyp, **kw)
            else:
                g, dataflow, _ = virtual_plan(
                    tuple(x.shape), tuple(w.shape), stride=op.stride,
                    pad=op.pad, pool=norm_pool(op.fuse_pool),
                    has_bypass=yb is not None, tiling=op.conv_tiling,
                    dataflow=op.dataflow)
                name = "conv2d_virtual"
                got = conv2d_virtual_cuda(xb, w, g, dataflow=dataflow,
                                          bypass=yb, **kw)
                want = conv2d_virtual_plain(xb, w, g, bypass=yb, **kw)
            if got.dtype != bf:
                fail(f"{name} {op.name} bf16 wrote {got.dtype}")
            err = max_err(got, want, BF16_TOL)
            rows.append({"kernel": name, "arch": f"{label} bf16",
                         "op": op.name, "max_abs_err": err})
            print(f"  {label:21s} {op.name:7s} {name:14s} bf16 err={err:.2e}"
                  f" (max |out| {want.float().abs().max().item():.1f})",
                  flush=True)
    return rows


def top2_ok(logits) -> "torch.Tensor":
    top = logits.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]) > 1e-4


def check_classes(res, device, label: str) -> int:
    """Every served class equals the plain path's on the card, batch by
    batch as the engine ran it, where the plain top-2 gap exceeds 1e-4;
    the kernel path's logits are held to the plain path's at 1e-4.
    Returns how many classes were compared."""
    import numpy as np
    import torch
    from repro_torch.runtime import executor
    eng, done = res["engine"], res["done"]
    got = [r.out_tokens[0] for r in done]
    images = np.stack(res["images"])
    n_cmp = 0
    for i in range(0, REQUESTS, SLOTS):
        chunk = images[i:i + SLOTS]
        pad = np.zeros((SLOTS - len(chunk),) + chunk.shape[1:], np.float32)
        x = torch.from_numpy(np.concatenate([chunk, pad])).to(device)
        ref = executor.run(eng.program, eng.params, x, impl="reference")
        ker = executor.run(eng.program, eng.params, x, impl="cuda")
        max_err(ker, ref)
        keep = top2_ok(ref)[:len(chunk)].tolist()
        want_ids = ref.argmax(-1)[:len(chunk)].tolist()
        for k, (ok, w) in enumerate(zip(keep, want_ids)):
            if ok:
                n_cmp += 1
                if got[i + k] != w:
                    fail(f"{label} request {i + k}: class {got[i + k]} != "
                         f"plain {w}")
    return n_cmp


def serve_alexnet(device, label: str = "5a"):
    """Phase 5a: the port's CNN serving entry point, on the kernels (5n:
    again off the tuned Program)."""
    from repro_torch.kernels.conv2d.kernel import conv2d_virtual_cuda
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    from repro_torch.launch import serve
    def run():
        return serve.main(["--arch", "alexnet-owt", "--slots", str(SLOTS),
                           "--requests", str(REQUESTS), "--seed", str(SEED)])
    conv2d_virtual_cuda.launches = 0
    matmul_cuda.launches = 0
    reset_matmul_paths()
    with Recorder() as rec:
        res = run()
    launches = {"conv2d_virtual": conv2d_virtual_cuda.launches,
                "matmul": matmul_cuda.launches}
    eng, done = res["engine"], res["done"]
    if len(done) != REQUESTS or not all(r.done for r in done):
        fail(f"{label}: served {len(done)} of {REQUESTS} requests")
    kinds = [op.kernel for op in eng.program.ops]
    want = {"conv2d_virtual": eng.n_ticks * kinds.count("conv2d"),
            "matmul": eng.n_ticks * kinds.count("matmul")}
    print(f"{label}: {eng.n_ticks} ticks, launches {launches}, want {want}")
    if launches != want:
        fail(f"{label}: launch counts {launches} != ticks x ops {want}")
    check_matmul_paths(label, want["matmul"], 0)
    n_cmp = check_classes(res, device, label)
    print(f"{label}: {n_cmp}/{REQUESTS} class ids compared, all equal "
          f"to the plain path; {REQUESTS / res['seconds']:.1f} img/s "
          f"({res['seconds']:.3f} s)")
    graphed = cnn_against_eager(label, run, res, rec)
    return launches, REQUESTS / res["seconds"], graphed


def cnn_against_eager(label, run, res, rec) -> dict:
    """A CNN main path's run off a captured CUDA graph, then served
    again eagerly: the same classes, every tick's logits bitwise equal
    (no cuBLAS on the path), the served ms per tick of both side by
    side.  Each engine then serves the same images ``CNN_REPEATS`` more
    times (recorded too), so the tick times are read over replays and
    not over the first call and the capture alone; one more tick is
    profiled."""
    import torch
    from repro_torch.runtime import executor
    eng = res["engine"]
    store = eng._infer.store(eng.params)
    if not check_captured(label, store.graphs, ()):
        fail(f"{label}: no CUDA graph was captured")
    serve_again(res)
    with executor.disable_graphs(), Recorder() as erec:
        eres = run()
        serve_again(eres)
    if ([r.out_tokens for r in eres["done"]]
            != [r.out_tokens for r in res["done"]]):
        fail(f"{label}: the graphed and eager classes differ")
    out = graphed_against_eager(label, store.capture_seconds, rec, erec,
                                None, exact=True)
    runner = executor.graphed_runner(eng.program, impl=eng.impl)
    x = torch.zeros((SLOTS,) + res["images"][0].shape, device=eng.device)
    out["profile"] = profile_replays(f"{label} tick", lambda: runner(
        eng.params, x), out["graphed_run_median_ms"])
    return out


def serve_paper_faithful(device, virtual_img_s: float, label: str = "5i",
                         turns: bool = True):
    """Phase 5i: the same 20 alexnet-owt images served off the SNOWFLAKE
    paper-faithful Program through ``serve_cnn`` and ``ServingEngine``,
    counters set to 0 just before and read just after: exactly ticks x 5
    strip launches, no zero-copy launch, ticks x 3 matmul launches; with
    ``turns``, then served in turns with 5a's Program.  Returns
    (launches, img/s, served ms per tick, graphed-against-eager
    stats)."""
    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.core import SNOWFLAKE
    from repro_torch.kernels.conv2d.kernel import (conv2d_strips_cuda,
                                                   conv2d_virtual_cuda)
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    from repro_torch.launch import serve
    from repro_torch.models import cnn
    program = cnn.compile_program(CNN_REGISTRY["alexnet-owt"], batch=SLOTS,
                                  hw=SNOWFLAKE, paper_faithful=True)
    counters = {"conv2d_strips": conv2d_strips_cuda,
                "conv2d_virtual": conv2d_virtual_cuda, "matmul": matmul_cuda}
    for fn in counters.values():
        fn.launches = 0
    reset_matmul_paths()

    def run():
        return serve.serve_cnn("alexnet-owt", slots=SLOTS, requests=REQUESTS,
                               device=device, seed=SEED, program=program)
    with Recorder() as rec:
        res = run()
    launches = {k: fn.launches for k, fn in counters.items()}
    eng, done = res["engine"], res["done"]
    if eng.program is not program:
        fail(f"{label}: the engine did not serve the Program it was given")
    if len(done) != REQUESTS or not all(r.done for r in done):
        fail(f"{label}: served {len(done)} of {REQUESTS} requests")
    kinds = [op.kernel for op in program.ops]
    if (kinds.count("conv2d"), kinds.count("matmul")) != (5, 3):
        fail(f"{label}: the Program lists {kinds}")
    want = {"conv2d_strips": eng.n_ticks * 5, "conv2d_virtual": 0,
            "matmul": eng.n_ticks * 3}
    print(f"{label} paper-faithful: {eng.n_ticks} ticks, launches "
          f"{launches}, want {want}")
    if launches != want:
        fail(f"{label}: launch counts {launches} != {want}")
    check_matmul_paths(f"{label} paper-faithful", want["matmul"], 0)
    n_cmp = check_classes(res, device, label)
    graphed = cnn_against_eager(label, run, res, rec)
    img_s = REQUESTS / res["seconds"]
    tick_ms = 1e3 * res["seconds"] / eng.n_ticks
    print(f"{label} paper-faithful: {n_cmp}/{REQUESTS} class ids compared, "
          f"all equal to the plain path; {img_s:.1f} img/s "
          f"({res['seconds']:.3f} s, {tick_ms:.3f} ms a tick) against 5a's "
          f"zero-copy {virtual_img_s:.1f} img/s", flush=True)
    if not turns:
        return launches, img_s, tick_ms, graphed
    # The two Programs in turns on the same images (zero-copy,
    # paper-faithful, paper-faithful, zero-copy): 5a ran first and
    # alone, so its reading and 5i's are not a like-for-like pair.
    rates = {"zero-copy": [], "paper-faithful": []}
    for kind in ("zero-copy", "paper-faithful", "paper-faithful",
                 "zero-copy"):
        r = serve.serve_cnn("alexnet-owt", slots=SLOTS, requests=REQUESTS,
                            device=device, seed=SEED,
                            program=program if kind == "paper-faithful"
                            else None)
        rates[kind].append(REQUESTS / r["seconds"])
    print(f"{label} in turns: " + ", ".join(
        f"{k} {' and '.join(f'{v:.1f}' for v in vs)} img/s"
        for k, vs in rates.items()), flush=True)
    return launches, img_s, tick_ms, graphed


def resnet18_forward(device, hw=None, paper_faithful=False):
    """One resnet18 batch-8 forward, kernels against plain; returns the
    strip launches it made."""
    import torch
    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.core import TPU_V5E
    from repro_torch.kernels.conv2d.kernel import conv2d_strips_cuda
    from repro_torch.models import cnn, init_params
    from repro_torch.runtime import executor
    cfg = CNN_REGISTRY["resnet18"]
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    params = init_params(cnn.param_defs(cfg), gen, device)
    x = torch.randn((SLOTS, 224, 224, 3), generator=gen, device=device)
    program = cnn.compile_program(cfg, batch=SLOTS, hw=hw or TPU_V5E,
                                  paper_faithful=paper_faithful)
    n0 = conv2d_strips_cuda.launches
    reset_matmul_paths()
    ker = executor.run(program, params, x, impl="cuda")
    strips = conv2d_strips_cuda.launches - n0
    check_matmul_paths(f"resnet18 ({program.hw_name})", sum(
        op.kernel == "matmul" for op in program.ops), 0)
    ref = executor.run(program, params, x, impl="reference")
    err = max_err(ker, ref)
    print(f"resnet18 batch {SLOTS} ({program.hw_name}, paper_faithful="
          f"{paper_faithful}): logits {tuple(ker.shape)}, max |err| "
          f"{err:.3e} against the plain path, {strips} strip launches")
    return strips


# --- the smollm-360m serving path ------------------------------------------------
def max_len_of(arch: str) -> int:
    """The served max_len of ``arch``'s pair: whisper-base's 448-token
    decoder context, 512 for the others."""
    return WHISPER_MAX_LEN if arch == WHISPER else LM_MAX_LEN


def lm_pairs(arch=LM_ARCH):
    """An LM config and its (prefill, decode) pairs at the main path's
    geometry: smollm-360m plain and windowed, another arch as it is."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config(arch)
    cfgs = [("full", cfg)]
    if arch == LM_ARCH:
        cfgs.append(("window", dataclasses.replace(cfg,
                                                   attn_window=LM_WINDOW)))
    return cfg, {name: transformer.compile_program_pair(
        c, slots=SLOTS, max_len=max_len_of(arch)) for name, c in cfgs}


def _weight_shape(defs, key):
    path, _, idx = key.partition(":")
    d = defs
    for part in path.split("/"):
        d = d[part]
    return d.shape[1:] if idx else d.shape


def lm_op_descs(cfg, pairs):
    """(distinct ops by description, per (pair, program) op counts).  A
    cross-attention op (whisper) runs the flash kernel over the slot's
    T_enc memory rows at prefill and the decode kernel over them at
    decode; an audio config also gets its encoder's attention (the flash
    kernel, non-causal, T_enc rows; the projections are plain ``@``),
    counted under ("full", "encoder") per admission."""
    from repro_torch.models import param_defs
    defs = param_defs(cfg)
    S = max_len_of(cfg.name)
    ops, uses = {}, {}
    for pname, pair in pairs.items():
        for kind, prog, M in (("prefill", pair.prefill, S),
                              ("decode", pair.decode, SLOTS)):
            count = Counter()
            for op in prog.ops:
                if op.kernel == "matmul":
                    K, N = _weight_shape(defs, op.param_key)[
                        ::-1 if op.transpose_w else 1]
                    desc = (f"matmul {M}x{K}x{N} {op.dataflow.name} "
                            f"block={op.block} act={op.fuse_activation} "
                            f"bypass={op.fuse_bypass}"
                            + (" b_transposed" if op.transpose_w else ""))
                    ops[desc] = ("matmul", op, (M, K, N))
                elif op.kernel == "cross_attention":
                    a, Te = op.attn, cfg.encoder_seq
                    name = ("flash_attention" if kind == "prefill"
                            else "decode_attention")
                    desc = (f"{name} cross h={a.heads}/{a.kv_heads}x"
                            f"{a.head_dim} memory={Te} "
                            + (f"S={S} bq={a.block_q} bkv={a.block_kv}"
                               if kind == "prefill" else f"slots={SLOTS}"))
                    ops[desc] = (name, op, (S, Te) if kind == "prefill"
                                 else (Te,))
                elif op.kernel in ("flash_attention", "decode_attention"):
                    a = op.attn
                    cache = min(S, a.window or S)
                    desc = (f"{op.kernel} h={a.heads}/{a.kv_heads}x"
                            f"{a.head_dim} window={a.window} "
                            + (f"S={S} bq={a.block_q} "
                               f"bkv={a.block_kv}" if kind == "prefill"
                               else f"cache={cache} slots={SLOTS}"))
                    ops[desc] = (op.kernel, op, (S, S) if kind == "prefill"
                                 else (cache,))
                else:
                    continue
                count[desc] += 1
            uses[(pname, kind)] = count
    if cfg.n_encoder_layers:
        from types import SimpleNamespace
        Te = cfg.encoder_seq
        enc = SimpleNamespace(kernel="encoder", attn=SimpleNamespace(
            heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            causal=False, window=None, block_q=None, block_kv=None))
        desc = (f"flash_attention encoder h={cfg.n_heads}/{cfg.n_kv_heads}"
                f"x{cfg.hd} S={Te}")
        ops[desc] = ("flash_attention", enc, (Te, Te))
        uses[("full", "encoder")] = Counter({desc: cfg.n_encoder_layers})
    return ops, uses


def lm_matmul_case(op, shape, dtype, device, gen):
    """One matmul op; a tied head (``transpose_w``) reads the (N, K)
    embedding transposed, and its library yardstick is ``torch.addmm``
    with the ``embed.T`` view."""
    import torch
    from repro_torch.kernels.common import apply_activation
    from repro_torch.kernels.matmul.kernel import matmul_cuda, matmul_plain
    M, K, N = shape
    bt = op.transpose_w
    a = torch.randn((M, K), generator=gen, device=device).to(dtype)
    w = (torch.randn((N, K) if bt else (K, N), generator=gen, device=device)
         * K ** -0.5).to(dtype)
    wk = w.T if bt else w                     # the (K, N) operand, a view
    byp = (torch.randn((M, N), generator=gen, device=device).to(dtype)
           if op.fuse_bypass else None)
    kw = dict(activation=op.fuse_activation, bypass=byp)
    block = tuple(min(v, -(-d // 128) * 128) for v, d in
                  zip(op.block, (M, K, N)))
    kern = lambda: matmul_cuda(a, w, dataflow=op.dataflow, block=block,
                               b_transposed=bt, **kw)
    plain = lambda: matmul_plain(a, w, b_transposed=bt, **kw)

    def library():
        out = torch.addmm(byp, a, wk) if byp is not None else a @ wk
        return apply_activation(out, op.fuse_activation)
    by = a.element_size()
    return (kern, plain, library, 2 * M * K * N,
            by * (M * K + K * N + M * N * (2 if byp is not None else 1)))


def lm_flash_case(op, dtype, device, gen, offset=False, shape=None,
                  batch: int = 1):
    """The kernel, plain and library callables of one flash op at the
    served width, with its FLOPs and bytes; ``offset``: the operands in
    buffers off a 16-byte boundary (``unaligned``).  ``shape``: (Sq, Skv),
    the rows of q and of k / v (default max_len both); a non-causal op
    (whisper's encoder and cross) attends every pair.  ``batch``
    sequences (a legacy forward's batch; a Program prefill's is 1)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)
    a = op.attn
    Sq, Skv = shape or (LM_MAX_LEN, LM_MAX_LEN)

    def heads(H, S):                 # the executor's (B, S, H, D) layout
        t = torch.randn((batch, S, H, a.head_dim), generator=gen,
                        device=device).to(dtype).transpose(1, 2)
        return unaligned(t) if offset else t
    q = heads(a.heads, Sq)
    k, v = heads(a.kv_heads, Skv), heads(a.kv_heads, Skv)
    scale = a.head_dim ** -0.5
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Skv, device=device)[None, :]
    allowed = ki <= qi if a.causal else torch.ones_like(qi == ki)
    if a.window:
        allowed &= ki > qi - a.window
    kern = lambda: flash_attention(q, k, v, causal=a.causal, window=a.window,
                                   block_q=a.block_q, block_kv=a.block_kv,
                                   impl="cuda")
    plain = lambda: flash_attention_plain(q, k, v, scale=scale,
                                          causal=a.causal, window=a.window,
                                          kv_len=None)[0]
    mask = None if not a.window else allowed
    library = lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=mask is None and a.causal,
        scale=scale, enable_gqa=True)
    by = q.element_size()
    pairs = batch * int(allowed.sum())
    return (kern, plain, library, 4 * a.head_dim * a.heads * pairs,
            batch * (by * a.head_dim * (2 * a.heads * Sq + 2 * a.kv_heads
                                        * Skv) + 4 * a.heads * Sq))


def _kv_lens(cache: int):
    """Mixed live lengths for 8 sequences; the cache-length ones are full
    rings that have wrapped."""
    lens = [1, 37, cache // 4, cache // 2, cache - 1, cache, cache,
            (3 * cache) // 4]
    return lens[:SLOTS]


def lm_decode_case(op, cache, dtype, device, gen, kv_dtype=None,
                   full=False, legacy=False):
    """One decode op: q in ``dtype``, the cache in ``kv_dtype`` (default
    ``dtype``; ``torch.float8_e4m3fn`` for the config's float8 caches).
    ``full``: every row live (a cross op over its encoder memory).
    ``legacy``: the legacy cache's contiguous (B, Hkv, S, D) layout, not
    a view of the Program's (slots, rows, kv heads, D) regions."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_plain)
    a = op.attn
    q = torch.randn((SLOTS, a.heads, a.head_dim), generator=gen,
                    device=device).to(dtype)
    # the (slots, rows, kv heads, D) cache regions, viewed (B, Hkv, S, D)
    rows = (SLOTS, a.kv_heads, cache) if legacy else (SLOTS, cache,
                                                      a.kv_heads)
    ck, cv = (torch.randn(rows + (a.head_dim,), generator=gen,
                          device=device).to(kv_dtype or dtype)
              for _ in range(2))
    k, v = (ck, cv) if legacy else (ck.transpose(1, 2), cv.transpose(1, 2))
    lens = [cache] * SLOTS if full else _kv_lens(cache)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    scale = a.head_dim ** -0.5
    kern = lambda: decode_attention(q, k, v, kv_len=kv_len, impl="cuda")
    plain = lambda: decode_attention_plain(q, k, v, kv_len, scale=scale)
    mask = (torch.arange(cache, device=device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    library = lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, scale=scale,
        enable_gqa=True)[:, :, 0]
    by, live = q.element_size(), sum(lens)
    return (kern, plain, library, 4 * a.head_dim * a.heads * live,
            by * (2 * q.numel() + 2 * a.kv_heads * a.head_dim * live)
            + 4 * SLOTS)


def flash_pads(op, Sq: int, Skv: int) -> bool:
    """The flash wrapper copies q, k and v into padded buffers at this op
    (``kernels/flash_attention/ops.py``'s rule: q to its block, or 128
    rows, k and v to the kv block)."""
    from repro_torch.kernels.flash_attention.ops import attention_block_sizes
    a = op.attn
    bq, bkv = a.block_q, a.block_kv
    if bq is None or bkv is None:
        bq, bkv = attention_block_sizes(Sq, Skv, a.head_dim, 2)
    bq = min(bq, Sq) if Sq % min(bq, Sq) == 0 else 128
    return bool(Sq % bq and Skv % bkv)


def check_lm_kernels(device, peaks, arch=LM_ARCH):
    """Phase 4, every distinct flash, decode and matmul op of ``arch``'s
    pairs; returns (rows by description, per (pair, program) op
    counts)."""
    import torch
    from repro_torch.kernels.decode_attention.kernel import decode_plan
    from repro_torch.kernels.matmul.kernel import matmul_plan
    cfg, pairs = lm_pairs(arch)
    ops, uses = lm_op_descs(cfg, pairs)
    fwd_paths = flash_wrappers()[0].path_launches
    rows = {}
    for i, (desc, (kernel, op, shape)) in enumerate(sorted(ops.items())):
        errs = []
        for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, BF16_TOL)):
            gen = torch.Generator(device=device).manual_seed(SEED + i)
            full = op.kernel == "cross_attention"
            if kernel == "matmul":
                case = lm_matmul_case(op, shape, dtype, device, gen)
            elif kernel == "flash_attention":
                case = lm_flash_case(op, dtype, device, gen, shape=shape)
            else:
                case = lm_decode_case(op, shape[0], dtype, device, gen,
                                      full=full)
            kern, plain, library, flops, nbytes = case
            before = dict(fwd_paths)
            errs.append(max_err(kern(), plain(), tol))
            if kernel == "flash_attention":
                # f32 on simt, bf16 (the served type) on mma.
                taken = [k for k in fwd_paths if fwd_paths[k] > before[k]]
                want = "simt" if dtype == torch.float32 else "mma"
                if taken != [want]:
                    fail(f"flash {desc} {dtype}: ran on {taken}, not "
                         f"{want}")
        if kernel == "decode_attention":
            # A float8 e4m3 cache (kv_dtype="float8") under bf16 and f32
            # q: widened to f32 inside the kernel, the plain version on
            # the same float8 values.
            for dtype, tol in ((torch.bfloat16, BF16_TOL),
                               (torch.float32, TOL)):
                gen = torch.Generator(device=device).manual_seed(SEED + i)
                fp8 = lm_decode_case(op, shape[0], dtype, device, gen,
                                     kv_dtype=torch.float8_e4m3fn, full=full)
                errs.append(max_err(fp8[0](), fp8[1](), tol))
            del fp8
        padded = kernel == "flash_attention" and flash_pads(op, *shape)
        if kernel == "flash_attention" and not padded:
            # bf16 on simt too, through operands off a 16-byte boundary
            # (where the wrapper pads q, k and v to its blocks, its
            # copies are aligned and no view reaches the kernel).
            gen = torch.Generator(device=device).manual_seed(SEED + i)
            case = lm_flash_case(op, torch.bfloat16, device, gen, offset=True,
                                 shape=shape)
            before = fwd_paths["simt"]
            errs.append(max_err(case[0](), case[1](), BF16_TOL))
            if fwd_paths["simt"] != before + 1:
                fail(f"flash {desc} unaligned bf16 did not run on simt")
        name = "flash_attention" if kernel == "flash_attention" else kernel
        row = {"kernel": name, "shape": desc, "err_f32": errs[0],
               "err_bf16": errs[1], "max_abs_err": max(errs),
               "ms": time_ms(kern), "plain_ms": time_ms(plain),
               "library_ms": time_ms(library),
               "flop_ms": flops / peaks["bfloat16"] * 1e3,
               "byte_ms": nbytes / peaks["hbm"] * 1e3}
        row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
        extra = ""
        if kernel == "matmul":
            row["path"] = matmul_plan(*shape, torch.bfloat16,
                                      b_transposed=op.transpose_w).path
            name = f"matmul/{row['path']}"
        elif kernel == "flash_attention":
            name = "flash/mma"
            extra = (" bf16 simt: not reached (padded copies)" if padded
                     else f" bf16 simt={errs[2]:.2e}")
        else:
            a = op.attn
            extra = (f" float8 cache: bf16 q {errs[2]:.2e}, f32 q "
                     f"{errs[3]:.2e}; " + plan_text(decode_plan(
                         SLOTS, a.heads, a.kv_heads, shape[0], a.head_dim,
                         torch.bfloat16)))
        rows[desc] = row
        print(f"  {name:16s} err f32={errs[0]:.2e} bf16={errs[1]:.2e}{extra} "
              f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
              f"lib={row['library_ms']:.4f} bound={row['bound_ms']:.4f} "
              f"| {desc}", flush=True)
        del case, kern, plain, library
    return rows, uses


def vlm_ops() -> dict:
    """The attention ops of llama-3.2-vision-11b's legacy path at the 5o
    shapes, by description: (kernel, op, shape, launches per forward or
    tick).  Its forward (8 prompts of ``VLM_PROMPT`` tokens) runs one
    causal self flash a layer and one non-causal cross flash a group over
    the ``n_vision_tokens`` rows; each decode step one decode a layer
    over the ring of ``LM_MAX_LEN`` rows and one a group over all the
    vision rows (the cross K/V)."""
    from types import SimpleNamespace
    from repro_torch.configs import get_config
    cfg = get_config(VLM_ARCH)
    G, Tv = cfg.n_layers // cfg.cross_attn_every, cfg.n_vision_tokens

    def op(causal):
        return SimpleNamespace(kernel="legacy", attn=SimpleNamespace(
            heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            causal=causal, window=None, block_q=None, block_kv=None))
    h = f"h={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} B={SLOTS}"
    return {
        f"flash_attention self {h} S={VLM_PROMPT} causal":
            ("flash_attention", op(True), (VLM_PROMPT, VLM_PROMPT),
             cfg.n_layers),
        f"flash_attention cross {h} Sq={VLM_PROMPT} Tv={Tv}":
            ("flash_attention", op(False), (VLM_PROMPT, Tv), G),
        f"decode_attention self {h} ring={LM_MAX_LEN}":
            ("decode_attention", op(True), (LM_MAX_LEN,), cfg.n_layers),
        f"decode_attention cross {h} memory={Tv}":
            ("decode_attention", op(False), (Tv,), G)}


def check_vlm_kernels(device, peaks) -> dict:
    """Phase 4, llama-3.2-vision-11b: the flash and decode kernels at
    ``vlm_ops``' shapes in the legacy path's layouts (flash: 8 sequences
    in the (B, S, H, D) layout the projections leave; decode: the legacy
    cache's contiguous (B, Hkv, S, D), mixed kv_len over the self ring,
    every row over the cross K/V), f32 (1e-4, simt) and bf16 (2^-7, mma),
    timed in bf16 beside the plain version, SDPA and the bound.  The
    cross flash's 1601 keys are no multiple of the kv block: the wrapper
    pads k and v and masks the padding through kv_len.  Returns rows by
    description, with ``uses`` (launches per forward or tick)."""
    import torch
    from repro_torch.kernels.decode_attention.kernel import decode_plan
    fwd_paths = flash_wrappers()[0].path_launches
    rows = {}
    for i, (desc, (kernel, op, shape, uses)) in enumerate(
            sorted(vlm_ops().items())):
        errs = []
        for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, BF16_TOL)):
            gen = torch.Generator(device=device).manual_seed(SEED + i)
            if kernel == "flash_attention":
                case = lm_flash_case(op, dtype, device, gen, shape=shape,
                                     batch=SLOTS)
            else:
                case = lm_decode_case(op, shape[0], dtype, device, gen,
                                      full="cross" in desc, legacy=True)
            kern, plain, library, flops, nbytes = case
            before = dict(fwd_paths)
            errs.append(max_err(kern(), plain(), tol))
            if kernel == "flash_attention":
                taken = [k for k in fwd_paths if fwd_paths[k] > before[k]]
                want = "simt" if dtype == torch.float32 else "mma"
                if taken != [want]:
                    fail(f"flash {desc} {dtype}: ran on {taken}, not {want}")
        row = {"kernel": kernel, "shape": desc, "uses": uses,
               "err_f32": errs[0], "err_bf16": errs[1],
               "max_abs_err": max(errs), "ms": time_ms(kern),
               "plain_ms": time_ms(plain), "library_ms": time_ms(library),
               "flop_ms": flops / peaks["bfloat16"] * 1e3,
               "byte_ms": nbytes / peaks["hbm"] * 1e3}
        row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
        extra = ""
        if kernel == "decode_attention":
            a = op.attn
            extra = " " + plan_text(decode_plan(
                SLOTS, a.heads, a.kv_heads, shape[0], a.head_dim,
                torch.bfloat16))
        rows[desc] = row
        print(f"  {kernel:16s} err f32={errs[0]:.2e} bf16={errs[1]:.2e}"
              f"{extra} ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
              f"lib={row['library_ms']:.4f} bound={row['bound_ms']:.4f} ("
              f"{'operations' if row['flop_ms'] >= row['byte_ms'] else 'bytes'}"
              f") x {uses} | {desc}", flush=True)
        del case, kern, plain, library
    for kernel, per in (("flash_attention", "forward"),
                        ("decode_attention", "tick")):
        mine = [r for r in rows.values() if r["kernel"] == kernel]
        print(f"{VLM_ARCH} {kernel} per {per}: "
              f"{sum(r['uses'] for r in mine)} launches, " + ", ".join(
                  f"{k} {sum(r['uses'] * r[k] for r in mine):.4f}"
                  for k in ("ms", "bound_ms", "plain_ms", "library_ms")))
    return rows


def paged_operands(pool_dtype, q_dtype, device, gen, D=None):
    """Phase 4's paged decode operands at the served geometry: (257, 16,
    5, 64) pools (head dim ``D`` where given), q for 8 sequences of
    ``_kv_lens(512)`` rows through a table of shuffled page ids -- the
    two full (wrapped) rings share their first 16 pages, sequences 3 and
    4 their first 8 -- and the null page 0 past each sequence's pages, as
    the PagePool leaves it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quant import int8_quantize_pages
    cfg = get_config(LM_ARCH)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, D or cfg.hd
    lens = _kv_lens(LM_MAX_LEN)
    q = torch.randn((SLOTS, Hq, D), generator=gen, device=device).to(q_dtype)
    kp, vp = (torch.randn((N_PAGES, PAGE_SIZE, Hkv, D), generator=gen,
                          device=device) for _ in range(2))
    ids = (torch.randperm(N_PAGES - 1, generator=gen, device=device)
           + 1).tolist()
    table = torch.zeros((SLOTS, LM_MAX_LEN // PAGE_SIZE), dtype=torch.int32)
    for b, n in enumerate(lens):
        for i in range(-(-n // PAGE_SIZE)):
            table[b, i] = ids.pop()
    table[6, :16] = table[5, :16]
    table[4, :8] = table[3, :8]
    scales = {}
    if pool_dtype == torch.int8:
        (kp, scales["k_scale"]), (vp, scales["v_scale"]) = map(
            int8_quantize_pages, (kp, vp))
    else:
        kp, vp = kp.to(pool_dtype), vp.to(pool_dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    return q, kp, vp, table.to(device), kv_len, scales


def paged_case(pool_dtype, q_dtype, device, gen, peaks):
    """One paged decode check: the kernel against its plain version
    (gather_pages + decode_attention_ref), and the callables timed beside
    it -- the contiguous kernel and SDPA (the library yardstick), both
    over the already-gathered (B, Hkv, S, D) view, so neither pays the
    gather.  The bound counts each distinct live page row once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import gather_pages
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda, decode_plan, paged_decode_attention_cuda,
        paged_decode_attention_plain)
    q, kp, vp, table, kv_len, scales = paged_operands(pool_dtype, q_dtype,
                                                      device, gen)
    B, Hq, D = q.shape
    Hkv, scale = kp.shape[2], D ** -0.5
    kern = lambda: paged_decode_attention_cuda(q, kp, vp, table, kv_len,
                                               scale=scale, **scales)
    plain = lambda: paged_decode_attention_plain(q, kp, vp, table, kv_len,
                                                 scale=scale, **scales)
    k = gather_pages(kp, table, scales.get("k_scale")).to(q_dtype)
    v = gather_pages(vp, table, scales.get("v_scale")).to(q_dtype)
    contiguous = lambda: decode_attention_cuda(q, k, v, kv_len, scale=scale)
    mask = (torch.arange(k.shape[2], device=device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    library = lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, scale=scale,
        enable_gqa=True)[:, :, 0]
    lens = kv_len.tolist()
    tab = table.tolist()
    rows = {(tab[b][r // PAGE_SIZE], r % PAGE_SIZE)
            for b, n in enumerate(lens) for r in range(n)}
    pages = {p for p, _ in rows}
    nbytes = (2 * len(rows) * Hkv * D * kp.element_size()
              + 2 * q.numel() * q.element_size()
              + 4 * (B + sum(-(-n // PAGE_SIZE) for n in lens))
              + (8 * len(pages) if scales else 0))
    flops = 4 * D * Hq * sum(lens)
    tol = TOL if q_dtype == torch.float32 else BF16_TOL
    err = max_err(kern(), plain(), tol)
    plan = decode_plan(B, Hq, Hkv, table.shape[1] * PAGE_SIZE, D, q_dtype,
                       kv_dtype=pool_dtype, page_size=PAGE_SIZE)
    peak = peaks["float32" if q_dtype == torch.float32 else "bfloat16"]
    row = {"pools": str(pool_dtype).removeprefix("torch."),
           "q": str(q_dtype).removeprefix("torch."), "max_abs_err": err,
           "ms": time_ms(kern), "plain_ms": time_ms(plain),
           "contiguous_ms": time_ms(contiguous),
           "library_ms": time_ms(library),
           "flop_ms": flops / peak * 1e3,
           "byte_ms": nbytes / peaks["hbm"] * 1e3,
           "live_rows": len(rows), "bytes": nbytes, "plan": plan_text(plan)}
    row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
    return row


def check_paged_kernel(device, peaks):
    """Phase 4, the paged decode op: f32 pools (1e-4), bf16 pools and
    int8 pools with bf16 q (2^-7); returns the rows by pool type."""
    import torch
    rows = {}
    for i, (pool_dtype, q_dtype) in enumerate((
            (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
            (torch.int8, torch.bfloat16))):
        gen = torch.Generator(device=device).manual_seed(SEED + 100 + i)
        row = paged_case(pool_dtype, q_dtype, device, gen, peaks)
        rows[row["pools"]] = row
        print(f"  paged_decode_attention {row['pools']} pools, {row['q']} q, "
              f"{row['plan']}: err={row['max_abs_err']:.2e} ms={row['ms']:.4f} "
              f"plain={row['plain_ms']:.4f} contiguous kernel="
              f"{row['contiguous_ms']:.4f} library (SDPA over the "
              f"already-gathered view)={row['library_ms']:.4f} "
              f"bound={row['bound_ms']:.4f} ({row['live_rows']} distinct "
              f"live rows, {row['bytes']} B) | lens "
              f"{_kv_lens(LM_MAX_LEN)} pools ({N_PAGES}, {PAGE_SIZE}, 5, 64)",
              flush=True)
    # Head dim 112 (zamba2-7b's), which pages on the card since the split
    # kernels: bf16 and int8 pools with bf16 q, checked, not timed.
    from repro_torch.kernels.decode_attention.kernel import (
        decode_plan, paged_decode_attention_cuda,
        paged_decode_attention_plain)
    for i, pool_dtype in enumerate((torch.bfloat16, torch.int8)):
        gen = torch.Generator(device=device).manual_seed(SEED + 110 + i)
        q, kp, vp, table, kv_len, scales = paged_operands(
            pool_dtype, torch.bfloat16, device, gen, D=112)
        kw = dict(scale=112 ** -0.5, **scales)
        err = max_err(paged_decode_attention_cuda(q, kp, vp, table, kv_len,
                                                  **kw),
                      paged_decode_attention_plain(q, kp, vp, table, kv_len,
                                                   **kw), BF16_TOL)
        rows[f"D112 {pool_dtype}"] = {"max_abs_err": err}
        plan = decode_plan(*q.shape[:2], kp.shape[2], table.shape[1]
                           * PAGE_SIZE, 112, q.dtype, kv_dtype=pool_dtype,
                           page_size=PAGE_SIZE)
        print(f"  paged_decode_attention D=112 {pool_dtype} pools, bf16 q, "
              f"{plan_text(plan)}: err={err:.2e} (untimed)", flush=True)
    return rows


def plan_text(plan) -> str:
    """A decode plan as phase 4 prints it."""
    return (f"plan {plan.splits} x {plan.split_rows} rows (tiles of "
            f"{plan.tile_rows}), {plan.grid[0] * plan.grid[1]} CTAs")


# (Bt, L, H, P, N, with h0, timed as): zamba2-7b's admission (h0 zero, as
# a prefill starts) and decode tick, an L that is not a multiple of the
# kernels' 64-step chunk, and a 2048-row prompt (32 chunks).
SSD_CASES = [(1, 512, 112, 64, 64, False, "admission"),
             (1, 512, 112, 64, 64, True, None),
             (8, 1, 112, 64, 64, True, "tick"),
             (1, 300, 112, 64, 64, True, None),
             (1, 2048, 112, 64, 64, True, "L2048")]
# (B, L, H, D, with s0, timed as): rwkv6-7b's admission, a short L, a
# 2048-row prompt, and head dim 48 (no power of two).
WKV_CASES = [(1, 512, 64, 64, False, "admission"),
             (1, 512, 64, 64, True, None), (8, 5, 64, 64, True, None),
             (1, 2048, 64, 64, True, "L2048"),
             (1, 512, 64, 48, True, "D48")]


def ssd_chunk_flops(Bt, L, H, P, N, dtype):
    """(FLOP, TF32 tensor-core FLOP issued) of ``ssd_plan``'s chunked form:
    per chunk of q rows, the local state (B o w)^T x (2 q N P), C B^T and
    G x on the causal half (q (q + 1) N and q (q + 1) P) and C S (2 q N
    P); 3xTF32 issues each f32 product three times, and a product with a
    bf16 side (exact in TF32) twice, C B^T of bf16 operands once.  None
    on the step path, which has no chunk products."""
    import torch
    from repro_torch.kernels.mamba2.kernel import ssd_plan
    plan = ssd_plan(Bt, L, H, P, N, dtype)
    if plan.path != "chunked":
        return None
    bf = dtype == torch.bfloat16
    flops = issued = 0
    for c in range(plan.n_chunks):
        q = min(plan.chunk, L - c * plan.chunk)
        parts = ((2 * q * N * P, 2 if bf else 3),
                 (q * (q + 1) * N, 1 if bf else 3),
                 (q * (q + 1) * P, 2 if bf else 3),
                 (2 * q * N * P, 2 if bf else 3))
        flops += sum(f for f, _ in parts)
        issued += sum(f * n for f, n in parts)
    return Bt * H * flops, Bt * H * issued


def ssd_plan_text(case, dtype) -> str:
    from repro_torch.kernels.mamba2.kernel import ssd_plan
    plan = ssd_plan(*case[:5], dtype)
    if plan.path == "step":
        return (f"plan step: {plan.grid[0] * plan.grid[1]} CTAs, 1 kernel, "
                f"{plan.smem[0]} B shared")
    return (f"plan chunked: {plan.n_chunks} chunks of {plan.chunk}, "
            f"{plan.grid[0] * plan.grid[1] * plan.grid[2]} CTAs a chunk "
            f"kernel, pass {plan.pass_grid[0] * plan.pass_grid[1]} CTAs, "
            f"cluster {plan.cluster}, {plan.kernels} kernels, shared "
            f"{plan.smem[0]} / {plan.smem[1]} B")


def wkv_plan_text(case, dtype) -> str:
    from repro_torch.kernels.rwkv6.kernel import wkv_plan
    plan = wkv_plan(*case[:4], dtype)
    g = plan.local_grid
    return (f"plan: {plan.n_chunks} chunks of {plan.chunk}, "
            f"{g[0] * g[1] * g[2]} local CTAs ({g[0]} column blocks, "
            f"{plan.rows} rows a thread), pass "
            f"{plan.pass_grid[0] * plan.pass_grid[1]} CTAs, "
            f"{plan.out_grid[0] * plan.out_grid[1] * plan.out_grid[2]} "
            f"output CTAs, cluster {plan.cluster}, {plan.kernels} kernels")


def ssd_case(case, dtype, device, gen):
    """One mamba2_scan check on the model's operands: x, B, C strided
    column slices of one (Bt, L, H*P + 2N) conv output, f32 dt from a
    softplus, A < 0.  Returns (kern, plain, flops, bytes, chunk-form
    work as (peak name, FLOP issued) or None).  The bound counts the
    recurrence's 5 N P f32 FLOP per step and head (decay, outer-product
    update, read-out) and x, B, C, dt, A, h0 read and y and the final
    state written once."""
    import torch
    from repro_torch.kernels.mamba2.kernel import (mamba2_scan_cuda,
                                                   mamba2_scan_plain)
    Bt, L, H, P, N, with_h0, _ = case
    xbc = torch.randn((Bt, L, H * P + 2 * N), generator=gen,
                      device=device).to(dtype)
    x = xbc[..., :H * P].reshape(Bt, L, H, P)
    B, C = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(
        torch.randn((Bt, L, H), generator=gen, device=device))
    A = -torch.exp(torch.randn((H,), generator=gen, device=device) * 0.5)
    h0 = (torch.randn((Bt, H, N, P), generator=gen, device=device)
          if with_h0 else None)
    kern = lambda: mamba2_scan_cuda(x, dt, A, B, C, h0=h0)
    plain = lambda: mamba2_scan_plain(x, dt, A, B, C, h0=h0)
    es = x.element_size()
    nbytes = (es * (2 * Bt * L * H * P + 2 * Bt * L * N) + 4 * Bt * L * H
              + 4 * H + 4 * Bt * H * N * P * (2 if with_h0 else 1))
    chunk = ssd_chunk_flops(Bt, L, H, P, N, dtype)
    return kern, plain, 5 * N * P * Bt * L * H, nbytes, (
        None if chunk is None else ("tfloat32", chunk[1]))


def wkv_case(case, dtype, device, gen):
    """One wkv6 check: r, k, v, w (w = exp(-exp(.)) in (0, 1)) in the
    model's (B, L, H, D) layout, u (H, D).  Returns (kern, plain, flops,
    bytes, chunk-form work as (peak name, FLOP)).  The bound counts 5 D^2
    f32 FLOP per step and head (read-out and decayed rank-1 update) and
    r, k, v, w, u, s0 read and y and the final state written once; the
    chunk form adds what the chunked kernels compute beyond it -- the
    state pass (2 D^2 a chunk) and the output product (r o a)^T S (2 D^2
    a step) -- at the f32 FMA rate."""
    import torch
    from repro_torch.kernels.rwkv6.kernel import (wkv6_cuda, wkv6_plain,
                                                  wkv_plan)
    B, L, H, D, with_s0, _ = case

    def rows():
        return torch.randn((B, L, H, D), generator=gen, device=device)
    r, k, v = (rows().to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(rows() * 0.5)).to(dtype)
    u = torch.randn((H, D), generator=gen, device=device).to(dtype)
    s0 = (torch.randn((B, H, D, D), generator=gen, device=device)
          if with_s0 else None)
    kern = lambda: wkv6_cuda(r, k, v, w, u, s0=s0)
    plain = lambda: wkv6_plain(r, k, v, w, u, s0=s0)
    nbytes = (r.element_size() * (5 * B * L * H * D + H * D)
              + 4 * B * H * D * D * (2 if with_s0 else 1))
    nc = wkv_plan(B, L, H, D, dtype).n_chunks
    return kern, plain, 5 * D * D * B * L * H, nbytes, (
        "float32", B * H * D * D * (7 * L + 2 * nc))


def check_ssm_kernels(device, peaks):
    """Phase 4, the recurrent kernels: each case in f32 (atol = rtol =
    1e-4) and bf16 (2^-7, y; the f32 state at 1e-4), against the plain
    version (the sequential f32 recurrence, y rounded once), with the
    plan it ran on; the served shapes, L = 2048 and wkv6's D = 48 timed
    in bf16, per launch, beside the plain version and the bounds.  No
    single PyTorch call computes either function, so neither has a
    library yardstick.  Returns {kernel: {"max_abs_err": e, "rows":
    {timed as: row}}}."""
    import torch
    out = {}
    for kernel, cases, make, text in (
            ("mamba2_scan", SSD_CASES, ssd_case, ssd_plan_text),
            ("wkv6", WKV_CASES, wkv_case, wkv_plan_text)):
        errs, rows = [], {}
        for i, case in enumerate(cases):
            for dtype, tol in ((torch.float32, TOL),
                               (torch.bfloat16, BF16_TOL)):
                gen = torch.Generator(device=device).manual_seed(
                    SEED + 300 + i)
                kern, plain, flops, nbytes, chunk = make(case, dtype,
                                                         device, gen)
                (y, s), (y_ref, s_ref) = kern(), plain()
                err = max(max_err(y, y_ref, tol), max_err(s, s_ref))
                errs.append(err)
                print(f"  {kernel} {case[:-1]} "
                      f"{str(dtype).removeprefix('torch.')}: max |err| "
                      f"{err:.2e}; {text(case, dtype)}", flush=True)
            timed = case[-1]
            if timed is not None:
                # The plain version is a Python loop of ~6 ops per step:
                # two calls (some 6,000 launches at L = 512) in the graph.
                row = {"ms": time_ms(kern),
                       "plain_ms": time_ms(plain, reps=2, warmup=1),
                       "library_ms": None,
                       "flop_ms": flops / peaks["float32"] * 1e3,
                       "byte_ms": nbytes / peaks["hbm"] * 1e3,
                       "chunk_ms": (None if chunk is None else
                                    chunk[1] / peaks[chunk[0]] * 1e3),
                       "flops": flops, "bytes": nbytes}
                row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
                rows[timed] = row
                chunk_ms = ("none (step path)" if chunk is None else
                            f"{row['chunk_ms']:.4f}")
                unit = "TF32 tensor-core" if kernel == "mamba2_scan" else \
                    "f32 FMA"
                print(f"  {kernel} bf16 {case[:-1]} ({timed}): "
                      f"ms={row['ms']:.4f} a launch, plain="
                      f"{row['plain_ms']:.4f} bound={row['bound_ms']:.4f} "
                      f"({flops / 1e9:.3f} GFLOP f32, {nbytes / 1e6:.2f} "
                      f"MB); chunk-form bound at the {unit} rate {chunk_ms}",
                      flush=True)
            del kern, plain, y, s, y_ref, s_ref
        out[kernel] = {"max_abs_err": max(errs), "rows": rows}
    return out


def _train_heads(B, S, H, dtype, device, gen, D):
    """(B, H, S, D) operands in the model's transposed (B, S, H, D)
    layout, as the legacy forward hands them to the kernels."""
    import torch
    return torch.randn((B, S, H, D), generator=gen, device=device).to(
        dtype).transpose(1, 2)


def bwd_magnitudes(q, k, v, out, lse, do, *, scale, causal, window,
                   kv_len):
    """Each of (dq, dk, dv)'s sum of absolute terms in the plain backward:
    the same products on |operands| with dP - delta taken as
    |dO| |V|^T + rowsum(|dO * O|), so every rounding error of the f32
    computation, dP's and delta's included, is bounded by the unit
    roundoff times the longest sum's length times this."""
    import torch
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    f = lambda t: t.float()
    kk = f(k).repeat_interleave(G, 1)
    vv = f(v).repeat_interleave(G, 1)
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Skv, device=q.device)[None, :]
    ok = ki < (Skv if kv_len is None else kv_len)
    if causal:
        ok = ok & (ki <= qi)
    if window:
        ok = ok & (ki > qi - window)
    s = (f(q) @ kk.transpose(-1, -2)) * scale
    pr = torch.exp(s.masked_fill(~ok, -1e30) - lse[..., None])
    a = pr * ((f(do).abs() @ vv.abs().transpose(-1, -2))
              + (f(do) * f(out)).abs().sum(-1, keepdim=True)) * scale
    return (a @ kk.abs(),
            (a.transpose(-1, -2) @ f(q).abs()).reshape(
                B, Hkv, G, Skv, D).sum(2),
            (pr.transpose(-1, -2) @ f(do).abs()).reshape(
                B, Hkv, G, Skv, D).sum(2))


def check_flash_bwd(device, peaks, arch=LM_ARCH):
    """Phase 4, the flash-attention backward at the training shape (B = 8,
    15 q / 5 kv heads of 64, S = 512): causal, window 128 and a
    kv_len = 450 mask (non-causal), in f32 (atol = rtol = 1e-4) and bf16
    (one bf16 ulp of the plain result plus the f32 rounding bound of its
    sums, ``max_err_ulp`` with ``bwd_slack`` x ``bwd_magnitudes``), each
    on the forward kernel's out and lse, against the plain version; the
    causal bf16 case also on simt (operands off a 16-byte boundary) at
    one bf16 ulp; the trainable wrapper's gradients against flash_ref's
    autograd in f32 at batch 2; then the causal bf16 case timed with the
    forward kernel at the same shape, SDPA's forward and SDPA's backward.
    Each bf16 case also prints, of the kernel and of the plain version
    with its key chunk cut from 512 to 64 (the same f32 sums in another
    order), how many elements lie past one ulp and the largest share of
    the f32 bound an element uses past that ulp.  For another ``arch``
    (granite's 16 q / 8 kv heads of 64) only the causal bf16 case runs,
    checked and timed.  Returns the timed row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_ref
    from repro_torch.kernels.flash_attention.bwd_kernel import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda, flash_attention_plain)
    from repro_torch.kernels.flash_attention.ref import flash_bwd_ref
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    full = arch == LM_ARCH
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B, S = TRAIN_BATCH, TRAIN_SEQ
    scale = D ** -0.5
    errs, row = [], None
    cases = (("causal", True, None, None), ("window 128", True, 128, None),
             ("kv_len 450", False, None, 450))[:3 if full else 1]
    for i, (label, causal, window, kv_len) in enumerate(cases):
        kw = dict(scale=scale, causal=causal, window=window, kv_len=kv_len)
        for dtype in (torch.float32, torch.bfloat16)[0 if full else 1:]:
            gen = torch.Generator(device=device).manual_seed(SEED + 200 + i)
            q, do = (_train_heads(B, S, Hq, dtype, device, gen, D)
                     for _ in range(2))
            k, v = (_train_heads(B, S, Hkv, dtype, device, gen, D)
                    for _ in range(2))
            out, lse = flash_attention_cuda(q, k, v, **kw)
            kern = lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                                    **kw)
            plain = lambda: flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                      **kw)
            got, want = kern(), plain()
            if dtype == torch.float32:
                err = max(max_err(g, w) for g, w in zip(got, want))
                note = "tolerance 1e-4"
            else:
                mags = bwd_magnitudes(q, k, v, out, lse, do, **kw)
                slack = bwd_slack(S, D)
                err, worst = map(max, zip(*(
                    max_err_ulp(g, w, slack * m)
                    for g, w, m in zip(got, want, mags))))
                reorder = flash_bwd_ref(q, k, v, out, lse, do, chunk=64,
                                        **kw)
                past = lambda xs: "; ".join(
                    "%d past, %.4f" % past_ulp(a, w, slack * m)
                    for a, w, m in zip(xs, want, mags))
                note = (f"tolerance one bf16 ulp + {slack:.3e} x the sum "
                        f"of absolute terms, worst element at {worst:.3f} "
                        f"of it; dq/dk/dv elements past one ulp and the "
                        f"largest share of the f32 bound used past it: "
                        f"kernel {past(got)}; plain version with 64-key "
                        f"chunks {past(reorder)}")
                del mags, reorder
                if label == "causal" and full:
                    # simt in bf16 too: operands off a 16-byte boundary.
                    simt = flash_attention_bwd_cuda.path_launches["simt"]
                    got_simt = flash_attention_bwd_cuda(
                        *map(unaligned, (q, k, v, out)), lse, unaligned(do),
                        **kw)
                    if flash_attention_bwd_cuda.path_launches["simt"] != (
                            simt + 1):
                        fail("flash_attention_bwd unaligned bf16 did not "
                             "run on simt")
                    err_simt = max(max_err_ulp(g, w)[0]
                                   for g, w in zip(got_simt, want))
                    errs.append(err_simt)
                    note += (f"; simt (operands off a 16-byte boundary) "
                             f"max |err| {err_simt:.2e} (tolerance one "
                             f"bf16 ulp)")
                    del got_simt
            errs.append(err)
            print(f"  flash_attention_bwd {label} "
                  f"{str(dtype).removeprefix('torch.')}: dq/dk/dv max |err| "
                  f"{err:.2e} ({note})", flush=True)
            if label == "causal" and dtype == torch.bfloat16:
                qi = torch.arange(S, device=device)
                pairs = int((qi[None, :] <= qi[:, None]).sum())
                n_q = B * Hq * S * D
                n_kv = B * Hkv * S * D
                # The function's own work: q, k, v, out, dO and lse read
                # once and dq, dk, dv written once; 5 products of 2 D FLOP
                # per unmasked pair (S, dP, dV, dK, dQ).  The kernel's
                # delta scratch and its dQ pass's second S and dP are its
                # own choices, not the function's, so they are not counted.
                nbytes = (q.element_size() * (4 * n_q + 4 * n_kv)
                          + 4 * B * Hq * S)
                flops = 5 * 2 * D * pairs * B * Hq
                fwd = lambda: flash_attention_cuda(q, k, v, **kw)
                leaves = [t.detach().clone().requires_grad_()
                          for t in (q, k, v)]
                sdpa = lambda: F.scaled_dot_product_attention(
                    *leaves, is_causal=True, scale=scale, enable_gqa=True)
                sdpa_bwd = lambda: torch.autograd.grad(sdpa(), leaves, do)
                # The forward at the same shape: q, k, v read, out and
                # lse written; 2 products of 2 D FLOP per unmasked pair.
                fwd_bytes = (q.element_size() * (2 * n_q + 2 * n_kv)
                             + 4 * B * Hq * S)
                fwd_flops = 2 * 2 * D * pairs * B * Hq
                sdpa_ms = time_ms(sdpa)
                row = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
                       "fwd_ms": time_ms(fwd),
                       "fwd_plain_ms": time_ms(
                           lambda: flash_attention_plain(q, k, v, **kw)),
                       "fwd_library_ms": sdpa_ms,
                       "fwd_bound_ms": max(
                           fwd_flops / peaks["bfloat16"] * 1e3,
                           fwd_bytes / peaks["hbm"] * 1e3),
                       "library_ms": time_ms(sdpa_bwd) - sdpa_ms,
                       "flop_ms": flops / peaks["bfloat16"] * 1e3,
                       "byte_ms": nbytes / peaks["hbm"] * 1e3,
                       "flops": flops, "bytes": nbytes}
                row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
            del got, want, kern, plain
    if not full:
        row["max_abs_err"] = max(errs)
        print(f"  flash_attention_bwd bf16 causal {arch} B={B} S={S} "
              f"{Hq}/{Hkv}x{D}: ms={row['ms']:.4f} plain="
              f"{row['plain_ms']:.4f} library={row['library_ms']:.4f} "
              f"bound={row['bound_ms']:.4f}; forward kernel "
              f"{row['fwd_ms']:.4f} ms (plain {row['fwd_plain_ms']:.4f}, "
              f"SDPA {row['fwd_library_ms']:.4f}, bound "
              f"{row['fwd_bound_ms']:.4f})", flush=True)
        return row
    # The trainable wrapper (forward kernel + backward kernel under
    # autograd) against flash_ref's own autograd, f32, batch 2.
    gen = torch.Generator(device=device).manual_seed(SEED + 210)
    q, do = (_train_heads(2, S, Hq, torch.float32, device, gen, D)
             for _ in range(2))
    k, v = (_train_heads(2, S, Hkv, torch.float32, device, gen, D)
            for _ in range(2))
    grads = []
    for fn in (lambda *t: flash_attention(*t, causal=True, impl="cuda"),
               lambda *t: flash_ref(*t, causal=True)):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, do))
    err = max(max_err(g, w) for g, w in zip(*grads))
    errs.append(err)
    print(f"  flash_attention autograd (forward + backward kernels) against "
          f"flash_ref's autograd, f32, batch 2: max |err| {err:.2e}")
    row["max_abs_err"] = max(errs)
    print(f"  flash_attention_bwd bf16 causal B={B} S={S} {Hq}/{Hkv}x{D}: "
          f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} library (SDPA "
          f"fwd+bwd minus fwd)={row['library_ms']:.4f} "
          f"bound={row['bound_ms']:.4f} ({row['flops'] / 1e9:.2f} GFLOP, "
          f"{row['bytes'] / 1e6:.2f} MB); forward kernel at the same shape "
          f"{row['fwd_ms']:.4f} ms (plain {row['fwd_plain_ms']:.4f}, SDPA "
          f"{row['fwd_library_ms']:.4f}, bound {row['fwd_bound_ms']:.4f})",
          flush=True)
    return row


def _tree_equal(a, b) -> bool:
    """Every leaf bit for bit (bf16 compared as its 16-bit words)."""
    import torch
    from repro_torch.checkpoint import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(bits(x), bits(y))
        for x, y in zip(la, lb))


def train_smoke(device):
    """Phase 5f, first: ``repro_torch.launch.train --smoke`` takes one step
    of the smoke config as it is (head dim 16, f32, 4 layers without
    remat), counters set to 0 just before and read just after: one flash
    forward and one backward launch per layer and a finite loss; then the
    same config's loss and gradients through the kernels against the
    plain path at 1e-4.  Returns the launches."""
    import math
    import shutil
    import tempfile
    import torch
    from repro_torch.launch import train
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import init_params, transformer
    counters = lm_counters()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_smoke_")
    try:
        for fn in counters.values():
            fn.launches = 0
        reset_flash_paths()
        res = train.main(["--arch", LM_ARCH, "--smoke", "--steps", "1",
                          "--batch", "2", "--seq", "64", "--ckpt-dir",
                          ckpt_dir, "--ckpt-every", "1", "--seed",
                          str(SEED)])
        launches = {k: fn.launches for k, fn in counters.items()}
        # The smoke config is f32: both flash kernels on simt.
        check_flash_paths("5f smoke", res["cfg"].n_layers,
                          res["cfg"].n_layers, path="simt")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = res["cfg"]
    L = cfg.n_layers
    want = {k: 0 for k in counters}
    want.update(flash_attention=L, flash_attention_bwd=L)
    loss = res["trainer"].metrics_history[0]["loss"]
    print(f"5f smoke: head dim {cfg.head_dim}, {L} layers, one step, loss "
          f"{loss:.4f}, launches {launches}, want {want}")
    if cfg.head_dim != 16 or launches != want or not math.isfinite(loss):
        fail("5f smoke: the smoke step did not run on the flash kernels")
    params = init_params(transformer.param_defs(cfg),
                         torch.Generator(device).manual_seed(SEED))
    gen = torch.Generator(device).manual_seed(SEED + 1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                              device=device) for k in ("tokens", "labels")}
    b0 = counters["flash_attention_bwd"].launches
    loss_k, grads_k = loss_and_grads(cfg, params, batch, impl="auto")
    if counters["flash_attention_bwd"].launches - b0 != L:
        fail("5f smoke: the kernel-path gradients missed the backward kernel")
    loss_r, grads_r = loss_and_grads(cfg, params, batch, impl="reference")
    err = max([max_err(loss_k, loss_r)] + [
        max_err(g, grads_r_leaf) for g, grads_r_leaf in zip(
            _named_leaves(grads_k).values(),
            _named_leaves(grads_r).values())])
    print(f"5f smoke: loss and every gradient through the kernels within "
          f"{err:.3e} of the plain path (tolerance {TOL})", flush=True)
    return launches


def _row_blocks(t, rows: int = 1 << 12):
    """``t`` as blocks of rows (every dim but the last flattened), so a
    7B model's stacked leaf is compared without a whole-leaf f32 copy."""
    if t.ndim < 2:
        return [t]
    return list(t.reshape(-1, t.shape[-1]).split(rows))


def leaf_diffs(a, b) -> dict:
    """{leaf name: (max |a - b| / max |b|, ||a - b|| / ||b||)}, a block
    of rows at a time."""
    nb = _named_leaves(b)
    out = {}
    for name, x in _named_leaves(a).items():
        d = m = dd = bb = 0.0
        for xp, yp in zip(_row_blocks(x), _row_blocks(nb[name])):
            xp, yp = xp.float(), yp.float()
            d = max(d, (xp - yp).abs().max().item())
            m = max(m, yp.abs().max().item())
            dd += (xp - yp).double().square().sum().item()
            bb += yp.double().square().sum().item()
        out[name] = (d / m, (dd / bb) ** 0.5)
    return out


# The second plain version of the recurrent families' step-0 floor: the
# plain path's chunked scans rounded otherwise -- mamba2's in f32 with y
# rounded once (the reference rounds its decay matrix to x's type before
# the product; the kernels and the sequential oracle do not), wkv6's (all
# f32 already) cut into chunks of 8 (the reference: 16).
WKV_RECHUNK = 8


@contextlib.contextmanager
def rounded_plain():
    """Inside, the plain path's chunked scans round otherwise (the
    comment above): the same functions, a second plain version."""
    from repro_torch.kernels.mamba2 import ops as scan_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    orig = scan_ops.mamba2_scan_chunked, wkv_ops.wkv6_chunked

    def scan(x, dt, A, B, C, *, return_state=False, **kw):
        out = orig[0](x.float(), dt, A, B.float(), C.float(),
                      return_state=return_state, **kw)
        if return_state:
            return out[0].to(x.dtype), out[1]
        return out.to(x.dtype)
    scan_ops.mamba2_scan_chunked = scan
    wkv_ops.wkv6_chunked = lambda *a, **k: orig[1](
        *a, chunk=WKV_RECHUNK, **k)
    try:
        yield
    finally:
        scan_ops.mamba2_scan_chunked, wkv_ops.wkv6_chunked = orig


def step0_against_plain(label, cfg, device, batch, params=None,
                        remat: bool = True, floor: bool = False):
    """Step 0 of a training run again, its loss and gradients through the
    kernels against the plain path on the card (``remat`` as the step;
    ``params`` the seed's unless given): loss within LOSS_RTOL, global
    gradient norm within GNORM_RTOL, each leaf's largest gradient
    difference within LEAF_RTOL of that leaf's largest gradient.

    With ``floor`` (the recurrent families, whose depth amplifies
    one-ulp differences past 5f's leaf gate) each leaf is held by its
    relative difference ||a - b|| / ||b||, which no single outlier
    drives, within LEAF_RTOL or twice the same quantity between the
    plain path and a second plain version that differs from it only in
    rounding (``rounded_plain``), whichever is larger; the loss and norm
    limits take the same floor.  Every leaf limit must stay under
    FLOOR_CAP (else the two plain versions disagree too far to tell a
    lost gradient), and each leaf's largest difference stays within
    FLOOR_CAP of its largest gradient: a lost, zeroed or negated leaf
    reads 1 or more on both measures.  Returns the kernel path's step-0
    loss."""
    import torch
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import init_params, param_defs
    from repro_torch.optim import global_norm
    if params is None:
        params = init_params(param_defs(cfg),
                             torch.Generator(device).manual_seed(SEED))

    def run(impl):
        loss, grads = loss_and_grads(cfg, params, batch, impl=impl,
                                     remat=remat)
        return float(loss), float(global_norm(grads)), grads

    loss_k, gn_k, grads_k = run("auto")
    loss_r, gn_r, grads_r = run("reference")
    diffs = leaf_diffs(grads_k, grads_r)
    del grads_k
    rel = lambda a, b: abs(a - b) / abs(b)
    d_loss, d_norm = rel(loss_k, loss_r), rel(gn_k, gn_r)
    lim = {"loss": LOSS_RTOL, "norm": GNORM_RTOL}
    # (measure, limit) per leaf: the max ratio, or with a floor the norm
    # ratio (the max ratio then held to FLOOR_CAP).
    held = {k: (mx, LEAF_RTOL) for k, (mx, _) in diffs.items()}
    note = ""
    if floor:
        with rounded_plain():
            loss_s, gn_s, grads_s = run("reference")
        fl = leaf_diffs(grads_s, grads_r)
        del grads_s
        f_loss, f_norm = rel(loss_s, loss_r), rel(gn_s, gn_r)
        lim = {"loss": max(LOSS_RTOL, 2 * f_loss),
               "norm": max(GNORM_RTOL, 2 * f_norm)}
        held = {k: (nr, max(LEAF_RTOL, 2 * fl[k][1]))
                for k, (_, nr) in diffs.items()}
        note = (f"; plain floor (mamba2 in f32, wkv6 in chunks of "
                f"{WKV_RECHUNK}): loss {f_loss:.2e}, norm {f_norm:.2e}, "
                f"leaves ||diff|| / ||grad|| (max ratio) " + ", ".join(
                    f"{k} {fl[k][1]:.4f} ({fl[k][0]:.4f})" for k in fl))
    del grads_r
    print(f"{label} step 0: loss kernels {loss_k:.6f} plain {loss_r:.6f} "
          f"(rel diff {d_loss:.2e}, bound {lim['loss']:.3g}); grad norm "
          f"kernels {gn_k:.6f} plain {gn_r:.6f} (rel diff {d_norm:.2e}, "
          f"bound {lim['norm']:.3g}){note}")
    what = ("||grad diff|| / ||grad|| (bound; max |grad diff| / max |grad|,"
            f" bound {FLOOR_CAP})" if floor else
            "max |grad diff| / max |grad| (bound)")
    print(f"{label} step 0 per-leaf {what}: " + ", ".join(
        f"{k} {r:.4f} ({b:.4f}" + (f"; {diffs[k][0]:.4f})" if floor else ")")
        for k, (r, b) in held.items()))
    wide = [k for k, (_, b) in held.items() if not b <= FLOOR_CAP]
    if wide:
        fail(f"{label} step 0: the plain floor sets leaf limits past "
             f"{FLOOR_CAP} ({wide}): no oracle at this depth")
    bad = [k for k, (r, b) in held.items() if not r <= b]
    if floor:
        bad += [k for k, (mx, _) in diffs.items() if not mx <= FLOOR_CAP]
    if not (d_loss <= lim["loss"] and d_norm <= lim["norm"]) or bad:
        fail(f"{label} step 0: kernel path disagrees with the plain path "
             f"(leaves over their bound: {bad})")
    return loss_k


def graphed_against_eager_steps(label, cfg, device, optimizer, data=None,
                                profile_eager: bool = True) -> dict:
    """COMPARE_STEPS training steps through the compiled step (step 0
    eager, step 1 captured and replayed, replays after) -- through
    ``runtime.Trainer`` over ``data`` when given (a small checkpoint),
    else called directly -- the launch counters set to 0 just before and
    read just after; then
    COMPARE_STEPS steps under ``executor.disable_graphs()``.  Each side
    starts from ``family_params`` and takes ``family_batch`` i at step
    i: every metric of every compared step and, after the last, every
    param and optimizer-state leaf bit for bit (the graphed side's
    copied to the host, so a 7B state is not held twice on the card).
    Each step is timed to a device synchronise; one more step a side
    (the graphed side's alone without ``profile_eager``) runs under the
    profiler (``profile_train``).  Returns the launches,
    the step ms (medians of the replays and of the eager steps past the
    first), the times, the losses, the graphed side's peak memory, the
    capture seconds and the profiles."""
    import gc
    import math
    import shutil
    import tempfile
    import torch
    from repro_torch.launch.steps import build_train_step
    from repro_torch.runtime import Trainer, TrainerConfig, executor
    counters = lm_counters()
    out, metrics, host = {}, {}, None
    for side in ("graphed", "eager"):
        t_side = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ctx = (executor.disable_graphs() if side == "eager"
               else contextlib.nullcontext())
        ckpt_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")
        try:
            with ctx:
                params = family_params(cfg, device)
                state = optimizer.init(params)
                step = build_train_step(cfg, optimizer)
                for fn in counters.values():
                    fn.launches = 0
                reset_flash_paths()
                ms, times = [], []
                if data is not None and side == "graphed":
                    trainer = Trainer(step, data, TrainerConfig(
                        total_steps=COMPARE_STEPS, ckpt_every=COMPARE_STEPS,
                        ckpt_dir=ckpt_dir, log_every=1), device=device)
                    params, state, done = trainer.run(params, state)
                    if done != COMPARE_STEPS:
                        fail(f"{label}: the Trainer ended at step {done}")
                    ms = [{k: r[k] for k in ("loss", "grad_norm", "lr")}
                          for r in trainer.metrics_history]
                    times = [1e3 * r["dt_s"]
                             for r in trainer.metrics_history]
                for i in range(len(ms), COMPARE_STEPS):
                    b = family_batch(cfg, i, device)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ms.append(step(params, state, b)[2])
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t0))
                    if i == 0:
                        torch.cuda.empty_cache()   # the eager step's blocks
                metrics[side] = [{k: float(v) for k, v in m.items()}
                                 for m in ms[:COMPARE_STEPS]]
                if side == "graphed":
                    out["launches"] = {k: fn.launches
                                       for k, fn in counters.items()}
                    out["flash_paths"] = flash_paths()
                    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                    out["losses"] = [float(m["loss"]) for m in ms]
                    host = _to_host((params, state))
                    captured = [g for g in step.graphs.graphs.values()
                                if g is not None]
                    if len(captured) != 1:
                        fail(f"{label}: {len(captured)} graphs captured for "
                             f"the train step, want 1")
                    out["capture_s"] = step.graphs.capture_seconds
                    del captured
                else:
                    out["same_state"] = _host_equal(host, (params, state))
                    if step.graphs.graphs:
                        fail(f"{label}: a graph was captured under "
                             f"disable_graphs()")
                # The steady state: the replays (from step 2), eager past 0.
                med = statistics.median(times[2:] if side == "graphed"
                                        else times[1:])
                out[f"{side}_ms"], out[f"{side}_times"] = med, times
                took(f"{label} {side} steps", t_side)
                t_side = time.perf_counter()
                out[f"{side}_profile"] = profile_train(
                    f"{label} {side} step", lambda: step(
                        params, state, family_batch(cfg, COMPARE_STEPS, device)),
                    med) if side == "graphed" or profile_eager else None
                took(f"{label} {side} profiled step", t_side)
                del params, state, step
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    del host
    gc.collect()
    torch.cuda.empty_cache()
    # Equal f32 values are equal bits (a NaN equals nothing).
    same_metrics = metrics["graphed"] == metrics["eager"] and all(
        math.isfinite(v) for m in metrics["graphed"] for v in m.values())
    losses = [[round(m["loss"], 6) for m in metrics[side]]
              for side in ("graphed", "eager")]
    print(f"{label}: {COMPARE_STEPS} steps graphed against {COMPARE_STEPS} "
          f"under disable_graphs(): losses {losses[0]} / {losses[1]}; every "
          f"metric bit-equal: {same_metrics}; params and optimizer state "
          f"bit-equal: {out['same_state']}; step ms graphed "
          f"{out['graphed_ms']:.2f} (median of the replays; "
          f"{[round(t, 2) for t in out['graphed_times']]}, step 1 with the "
          f"capture, {out['capture_s']:.2f} s) / eager {out['eager_ms']:.2f} "
          f"(median past step 0; {[round(t, 2) for t in out['eager_times']]})"
          f"; peak memory allocated {out['peak_gb']:.2f} GB", flush=True)
    if not (same_metrics and out["same_state"]):
        fail(f"{label}: the graphed steps are not bitwise equal to the "
             f"eager ones")
    return out


def train_lm(device, bwd_row):
    """Phase 5f: ``repro_torch.launch.train`` in process on full-width
    smollm-360m (bf16, batch 8, seq 512, SyntheticLM seed 0, AdamW with
    the CLI's cosine schedule) through the compiled step (step 0 eager,
    step 1 captured, replays after), counters set to 0 just before it
    and read just after: per step exactly 64 flash forward launches (32
    layers, each recomputed under remat) and 32 backward, no matmul or
    decode launch; every loss finite.  Then the same params and step-0
    batch through the plain path on the card (``step0_against_plain``),
    a fresh trainer resumed from the last checkpoint (at the saved step,
    params and optimizer state equal bit for bit), and the compiled step
    against the eager one (``graphed_against_eager_steps``).  Returns
    (launches, stats)."""
    import math
    import shutil
    import tempfile
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import init_params, transformer
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer, TrainerConfig
    counters = lm_counters()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        for fn in counters.values():
            fn.launches = 0
        reset_flash_paths()
        torch.cuda.reset_peak_memory_stats()
        res = train.main(["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS),
                          "--batch", str(TRAIN_BATCH), "--seq",
                          str(TRAIN_SEQ), "--ckpt-dir", ckpt_dir,
                          "--ckpt-every", str(TRAIN_STEPS),
                          "--seed", str(SEED)])
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        cfg, trainer = res["cfg"], res["trainer"]
        hist = trainer.metrics_history
        L, n = cfg.n_layers, len(hist)
        want = {"flash_attention": 2 * L * n, "flash_attention_bwd": L * n,
                "decode_attention": 0, "paged_decode_attention": 0,
                "matmul": 0, "mamba2_scan": 0, "wkv6": 0}
        print(f"5f train: {n} steps, launches {launches}, want {want}")
        if n != TRAIN_STEPS or res["step"] != TRAIN_STEPS:
            fail(f"5f train: {n} steps recorded, ended at {res['step']}")
        if launches != want:
            fail(f"5f train: launch counts {launches} != {want}")
        check_flash_paths("5f train", 2 * L * n, L * n)
        losses = [r["loss"] for r in hist]
        if not all(math.isfinite(x) for x in losses):
            fail(f"5f train: non-finite loss in {losses}")

        batch = {k: torch.from_numpy(v).to(device) for k, v in SyntheticLM(
            vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
            seed=0).batch_at(0).items()}
        step0_against_plain("5f", cfg, device, batch)

        # A fresh trainer resumes from the last checkpoint.
        optimizer = AdamW()
        fresh = init_params(transformer.param_defs(cfg),
                            torch.Generator(device).manual_seed(SEED + 1))
        resumed = Trainer(build_train_step(cfg, optimizer), None,
                          TrainerConfig(total_steps=TRAIN_STEPS,
                                        ckpt_every=TRAIN_STEPS,
                                        ckpt_dir=ckpt_dir), device=device)
        p2, o2, step2 = resumed.run(fresh, optimizer.init(fresh))
        same = (_tree_equal(p2, res["params"])
                and _tree_equal(o2, res["opt_state"]))
        size = sum(os.path.getsize(os.path.join(dp, f))
                   for dp, _, fs in os.walk(ckpt_dir) for f in fs)
        print(f"5f resume: restored step {step2}, "
              f"{len(resumed.metrics_history)} steps run, params and "
              f"optimizer state bit-equal: {same} "
              f"(checkpoint {size / 1e9:.2f} GB)")
        if step2 != TRAIN_STEPS or resumed.metrics_history or not same:
            fail("5f resume: the checkpoint did not restore the trained state")
        del fresh, p2, o2, res
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    # The CLI's step 1 holds the capture; steps 2 on are replays.
    step_ms = 1e3 * statistics.mean(r["dt_s"] for r in hist[2:])
    compare = graphed_against_eager_steps("5f", cfg, device, AdamW())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    stats = {**compare, "step_ms": step_ms, "tok_s": tokens / (step_ms / 1e3),
             "warmup_ms": 1e3 * hist[0]["dt_s"],
             "capture_ms": 1e3 * hist[1]["dt_s"], "losses": losses,
             "fwd_ms": 2 * L * bwd_row["fwd_ms"], "bwd_ms": L * bwd_row["ms"],
             "peak_gb": peak / 1e9}
    print(f"5f train: {stats['tok_s']:.0f} tokens/s trained, step "
          f"{step_ms:.2f} ms mean over the replayed steps 2-{n - 1} (step 0 "
          f"eager {stats['warmup_ms']:.1f} ms, step 1 with the capture "
          f"{stats['capture_ms']:.1f} ms); graphed {compare['graphed_ms']:.2f}"
          f" / eager {compare['eager_ms']:.2f} ms a step; flash forward "
          f"{2 * L} x {bwd_row['fwd_ms']:.4f} = {stats['fwd_ms']:.2f} ms and "
          f"backward {L} x {bwd_row['ms']:.4f} = {stats['bwd_ms']:.2f} ms of "
          f"kernel time per step; peak memory allocated "
          f"{stats['peak_gb']:.2f} GB; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    return launches, stats


def train_moe(device, bwd_row):
    """Phase 5k: ``repro_torch.launch.train --arch granite-moe-1b-a400m``
    at full width and depth in bf16 (24 layers, 32 experts top-8; batch
    8, seq 512, 8-bit AdamW moments) through the compiled step, counters
    set to 0 just before it and read just after: per step 48 flash
    forward launches (remat) and 24 backward, no matmul or decode
    launch; every loss (the load-balance term included) and expert
    imbalance finite.  Then step 0 through the plain path
    (``step0_against_plain``) and the compiled step against the eager
    one (``graphed_against_eager_steps``).  ``bwd_row``: phase 4's flash
    rows at granite's training shape.  Returns (launches, stats)."""
    import gc
    import math
    import shutil
    import tempfile
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.steps import AUX_LOSS_WEIGHT
    from repro_torch.optim import AdamW
    gc.collect()
    torch.cuda.empty_cache()
    counters = lm_counters()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    try:
        for fn in counters.values():
            fn.launches = 0
        reset_flash_paths()
        torch.cuda.reset_peak_memory_stats()
        res = train.main(["--arch", MOE_ARCH, "--steps", str(MOE_STEPS),
                          "--batch", str(TRAIN_BATCH), "--seq",
                          str(TRAIN_SEQ), "--ckpt-dir", ckpt_dir,
                          "--ckpt-every", str(MOE_STEPS), "--opt-bits", "8",
                          "--seed", str(SEED)])
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg, hist = res["cfg"], res["trainer"].metrics_history
    del res
    L, n = cfg.n_layers, len(hist)
    fwd = (2 if L >= 16 else 1) * L          # remat from 16 layers on
    want = {"flash_attention": fwd * n, "flash_attention_bwd": L * n,
            "decode_attention": 0, "paged_decode_attention": 0,
            "matmul": 0, "mamba2_scan": 0, "wkv6": 0}
    print(f"5k train: {n} steps, launches {launches}, want {want}")
    if n != MOE_STEPS or launches != want:
        fail(f"5k train: {n} steps, launch counts {launches} != {want}")
    check_flash_paths("5k train", fwd * n, L * n)
    losses = [r["loss"] for r in hist]
    imb = [r["moe_imbalance_pct"] for r in hist]
    if not all(math.isfinite(x) for x in losses + imb):
        fail(f"5k train: non-finite loss or imbalance in {losses}, {imb}")
    gc.collect()
    torch.cuda.empty_cache()
    batch = {k: torch.from_numpy(v).to(device) for k, v in SyntheticLM(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0).batch_at(0).items()}
    loss0 = step0_against_plain("5k", cfg, device, batch)
    del batch
    compare = graphed_against_eager_steps("5k", cfg, device,
                                          AdamW(state_bits=8))
    step_ms = 1e3 * statistics.mean(r["dt_s"] for r in hist[2:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    stats = {**compare, "step_ms": step_ms, "tok_s": tokens / (step_ms / 1e3),
             "warmup_ms": 1e3 * hist[0]["dt_s"],
             "capture_ms": 1e3 * hist[1]["dt_s"], "losses": losses,
             "imbalance": imb, "peak_gb": peak / 1e9,
             "fwd_ms": fwd * bwd_row["fwd_ms"], "bwd_ms": L * bwd_row["ms"]}
    print(f"5k train: {stats['tok_s']:.0f} tokens/s trained, step "
          f"{step_ms:.2f} ms (the replayed steps 2-{n - 1}; step 0 eager "
          f"{stats['warmup_ms']:.1f} ms, step 1 with the capture "
          f"{stats['capture_ms']:.1f} ms); graphed {compare['graphed_ms']:.2f}"
          f" / eager {compare['eager_ms']:.2f} ms a step; losses "
          f"{[round(x, 4) for x in losses]}, each with {AUX_LOSS_WEIGHT} x "
          f"the load-balance loss (step 0 through the kernels again "
          f"{loss0:.4f}); expert imbalance {[round(x, 1) for x in imb]}%; "
          f"flash forward {fwd} x {bwd_row['fwd_ms']:.4f} = "
          f"{stats['fwd_ms']:.2f} ms and backward {L} x {bwd_row['ms']:.4f} "
          f"= {stats['bwd_ms']:.2f} ms of kernel time per step; peak memory "
          f"allocated {stats['peak_gb']:.2f} GB", flush=True)
    return launches, stats


# Phase 4's training cases of this slice: the recurrent kernels' autograd
# Functions at the training shapes, (label, kind, shape) -- zamba2-7b's
# (8, 512, 112 heads of 64, N 64), the mamba2 config's (8, 512, 80, 64,
# N 128), rwkv6-7b's (8, 512, 64 heads of 64) -- and the flash kernels at
# the training phases' attention shapes, (label, B, Hq, Hkv, Sq, Skv, D,
# causal, window).
TRAIN_SCANS = (("zamba2-7b", "mamba2_scan", (8, 512, 112, 64, 64)),
               ("mamba2", "mamba2_scan", (8, 512, 80, 64, 128)),
               ("rwkv6-7b", "wkv6", (8, 512, 64, 64)))
TRAIN_ATTN = (("zamba2-7b shared", 8, 32, 32, 512, 512, 112, True, 4096),
              ("whisper encoder", 8, 8, 8, 1500, 1500, 64, False, None),
              ("whisper self", 8, 8, 8, 448, 448, 64, True, None),
              ("whisper cross", 8, 8, 8, 448, 1500, 64, False, None),
              ("vlm self", 8, 32, 8, 512, 512, 128, True, None),
              ("vlm cross", 8, 32, 8, 512, 1601, 128, False, None))


def scan_train_operands(kind, shape, device, gen):
    """The operands of one training-shape scan as the models hand them
    (bf16; mamba2's x, B and C strided column slices of one leaf), the
    leaves to differentiate, their names, and (flops, bytes) of the
    recurrence as ``ssd_case`` / ``wkv_case`` count them."""
    import torch
    bf = torch.bfloat16
    if kind == "mamba2_scan":
        Bt, L, H, P, N = shape
        xbc = torch.randn((Bt, L, H * P + 2 * N), generator=gen,
                          device=device).to(bf).requires_grad_()
        dt = torch.nn.functional.softplus(torch.randn(
            (Bt, L, H), generator=gen, device=device)).requires_grad_()
        A = (-torch.exp(torch.randn((H,), generator=gen, device=device)
                        * 0.5)).requires_grad_()
        leaves = [xbc, dt, A]

        def args(ls=leaves):
            xbc_, dt_, A_ = ls
            x = xbc_[..., :H * P].reshape(Bt, L, H, P)
            return (x, dt_, A_, xbc_[..., H * P:H * P + N],
                    xbc_[..., H * P + N:])
        nbytes = 2 * (2 * Bt * L * H * P + 2 * Bt * L * N) + 4 * Bt * L * H \
            + 4 * H + 4 * Bt * H * N * P
        return args, leaves, 5 * N * P * Bt * L * H, nbytes
    B, L, H, D = shape
    r, k, v = (torch.randn((B, L, H, D), generator=gen, device=device)
               .to(bf).requires_grad_() for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((B, L, H, D), generator=gen,
                                         device=device) * 0.5)).to(
        bf).requires_grad_()
    u = torch.randn((H, D), generator=gen, device=device).requires_grad_()
    leaves = [r, k, v, w, u]
    nbytes = 2 * 5 * B * L * H * D + 4 * H * D + 4 * B * H * D * D
    return (lambda ls=leaves: tuple(ls)), leaves, 5 * D * D * B * L * H, \
        nbytes


def check_train_scans(device, peaks):
    """Phase 4, the recurrent kernels under autograd at the training
    shapes (``TRAIN_SCANS``), bf16: the op (``mamba2_scan`` / ``wkv6``
    under grad mode, its autograd Function: one kernel launch forward,
    the chunked form recomputed backward): y against the kernel's plain
    version (the sequential f32 recurrence) at 2^-7, and each gradient --
    (dx, dB, dC) as one strided leaf, ddt, dA; or (dr, dk, dv, dw, du) --
    against autograd through the plain chunked form on the same inputs
    and upstream gradient, within 2^-7 of its largest |grad| plus 2^-7
    relative.  Timed: the kernel's forward launch (``ms``), the chunked
    forward (``plain_ms``), and forward + backward through each.  The
    bound is the recurrence's, as in the served rows; no PyTorch call
    computes either function.  Returns (max |err|, {label: row})."""
    import torch
    from repro_torch.kernels.mamba2 import mamba2_scan
    from repro_torch.kernels.mamba2.kernel import (mamba2_scan_cuda,
                                                   mamba2_scan_plain)
    from repro_torch.kernels.mamba2.ref import mamba2_scan_chunked
    from repro_torch.kernels.rwkv6 import wkv6
    from repro_torch.kernels.rwkv6.kernel import wkv6_cuda, wkv6_plain
    from repro_torch.kernels.rwkv6.ref import wkv6_chunked
    errs, rows = [], {}
    for i, (label, kind, shape) in enumerate(TRAIN_SCANS):
        gen = torch.Generator(device=device).manual_seed(SEED + 600 + i)
        args, leaves, flops, nbytes = scan_train_operands(kind, shape,
                                                          device, gen)
        if kind == "mamba2_scan":
            op = lambda ls=leaves: mamba2_scan(*args(ls))
            plain = lambda ls=leaves: mamba2_scan_chunked(*args(ls))
            kern = lambda: mamba2_scan_cuda(*args())
            seq = lambda: mamba2_scan_plain(*args())[0]
            launcher = mamba2_scan_cuda
        else:
            op = lambda ls=leaves: wkv6(*args(ls))
            plain = lambda ls=leaves: wkv6_chunked(*args(ls))
            kern = lambda: wkv6_cuda(*args())
            seq = lambda: wkv6_plain(*args())[0]
            launcher = wkv6_cuda
        n0 = launcher.launches
        y = op()
        if launcher.launches != n0 + 1 or "Trainable" not in type(
                y.grad_fn).__name__:
            fail(f"{label} {kind}: grad mode did not launch the kernel "
                 f"through its autograd Function ({y.grad_fn})")
        y_ref = plain()
        dy = torch.randn(y.shape, generator=gen, device=device).to(y.dtype)
        got = torch.autograd.grad(y, leaves, dy)
        want = torch.autograd.grad(y_ref, leaves, dy)
        if launcher.launches != n0 + 1:
            fail(f"{label} {kind}: the backward launched the kernel")
        with torch.no_grad():
            err = max_err(y, seq(), BF16_TOL)
        parts = []
        for leaf, g, w in zip(leaves, got, want):
            g, w = g.float(), w.float()
            scale = w.abs().max().item()
            e = (g - w).abs()
            if not (torch.isfinite(g).all() and bool(
                    (e <= BF16_TOL * (scale + w.abs())).all())):
                fail(f"{label} {kind}: the gradient of a "
                     f"{tuple(leaf.shape)} input disagrees with the "
                     f"chunked form's autograd (max |err| "
                     f"{e.max().item():.3e}, max |grad| {scale:.3e})")
            parts.append(f"{tuple(leaf.shape)} {e.max().item():.2e} / "
                         f"{scale:.2e}")
        errs.append(err)
        def fb(f):
            # Leaves made inside the timed (captured) call, as the
            # training step makes its own: autograd then keeps every
            # node on the capturing stream.
            def run():
                ls = [t.detach().requires_grad_() for t in leaves]
                return torch.autograd.grad(f(ls), ls, dy)
            return run
        row = {"ms": time_ms(kern), "plain_ms": time_ms(plain, reps=3,
                                                        warmup=1),
               "train_ms": time_ms(fb(op), reps=3, warmup=1),
               "plain_train_ms": time_ms(fb(plain), reps=3, warmup=1),
               "library_ms": None,
               "flop_ms": flops / peaks["float32"] * 1e3,
               "byte_ms": nbytes / peaks["hbm"] * 1e3,
               "max_abs_err": err}
        row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
        rows[label] = row
        print(f"  {kind} under autograd, {label} {shape} bf16: y max |err| "
              f"{err:.2e} (2^-7, against the sequential f32 recurrence); "
              f"gradients against the chunked form's autograd (max |err| / "
              f"max |grad|): "
              + ", ".join(parts) + f"; ms={row['ms']:.4f} (the forward "
              f"launch) plain={row['plain_ms']:.4f} (the chunked form) "
              f"bound={row['bound_ms']:.4f}; forward + backward "
              f"{row['train_ms']:.3f} ms (the kernel, then the chunked "
              f"recompute) against {row['plain_train_ms']:.3f} (the "
              f"chunked form both ways)", flush=True)
        del y, y_ref, got, want, leaves
    return max(errs), rows


def check_train_attention(device, peaks):
    """Phase 4, the flash kernels at the training phases' attention shapes
    (``TRAIN_ATTN``), bf16, as the trainable wrapper hands them to the
    kernels: q, k and v in the model's transposed layout, padded by the
    wrapper's rule (``ops._pads``: q to its block, k and v to the kv
    block, the padded keys masked through kv_len).  The forward kernel
    against its plain version at 2^-7, the backward kernel on its out and
    lse against ``flash_bwd_ref`` (one bf16 ulp plus the f32 rounding
    bound, as ``check_flash_bwd``); then each timed with its plain
    version and SDPA (the backward: SDPA forward + backward minus
    forward) on the unpadded operands.  Bounds count the unpadded,
    unmasked work.  Returns (max |err| forward, backward, {label:
    row})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.bwd_kernel import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda, flash_attention_plain)
    from repro_torch.kernels.flash_attention.ops import (
        _pads, attention_block_sizes)
    bf = torch.bfloat16
    fwd_errs, bwd_errs, rows = [], [], {}
    for i, (label, B, Hq, Hkv, Sq, Skv, D, causal, window) in enumerate(
            TRAIN_ATTN):
        gen = torch.Generator(device=device).manual_seed(SEED + 700 + i)
        q, do = (_train_heads(B, Sq, Hq, bf, device, gen, D)
                 for _ in range(2))
        k, v = (_train_heads(B, Skv, Hkv, bf, device, gen, D)
                for _ in range(2))
        bq, bkv = attention_block_sizes(Sq, Skv, D, 2, window=window)
        pad_q, pad_kv = _pads(Sq, Skv, bq, bkv)
        kv_len = Skv if pad_kv else None
        qp, dop = ((F.pad(t, (0, 0, 0, pad_q)) if pad_q else t)
                   for t in (q, do))
        kp, vp = ((F.pad(t, (0, 0, 0, pad_kv)) if pad_kv else t)
                  for t in (k, v))
        kw = dict(scale=D ** -0.5, causal=causal, window=window,
                  kv_len=kv_len)
        out, lse = flash_attention_cuda(qp, kp, vp, **kw)
        ref, _ = flash_attention_plain(qp, kp, vp, **kw)
        fwd_errs.append(max_err(out, ref, BF16_TOL))
        kern = lambda: flash_attention_bwd_cuda(qp, kp, vp, out, lse, dop,
                                                **kw)
        plain = lambda: flash_attention_bwd_plain(qp, kp, vp, out, lse, dop,
                                                  **kw)
        got, want = kern(), plain()
        mags = bwd_magnitudes(qp, kp, vp, out, lse, dop, **kw)
        slack = bwd_slack(Skv + pad_kv, D)
        err, worst = map(max, zip(*(max_err_ulp(g, w, slack * m)
                                    for g, w, m in zip(got, want, mags))))
        bwd_errs.append(err)
        del got, want, mags, ref
        qi = torch.arange(Sq, device=device)[:, None]
        ki = torch.arange(Skv, device=device)[None, :]
        ok = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
        if causal:
            ok &= ki <= qi
        if window:
            ok &= ki > qi - window
        pairs = int(ok.sum())
        n_q, n_kv = B * Hq * Sq * D, B * Hkv * Skv * D
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        sdpa = lambda: F.scaled_dot_product_attention(
            *leaves, is_causal=causal, scale=D ** -0.5, enable_gqa=True)
        sdpa_ms = time_ms(sdpa)
        flops = 5 * 2 * D * pairs * B * Hq
        nbytes = 2 * (4 * n_q + 4 * n_kv) + 4 * B * Hq * Sq
        fwd_flops = 2 * 2 * D * pairs * B * Hq
        fwd_bytes = 2 * (2 * n_q + 2 * n_kv) + 4 * B * Hq * Sq
        row = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
               "library_ms": time_ms(lambda: torch.autograd.grad(
                   sdpa(), leaves, do)) - sdpa_ms,
               "flop_ms": flops / peaks["bfloat16"] * 1e3,
               "byte_ms": nbytes / peaks["hbm"] * 1e3,
               "fwd_ms": time_ms(lambda: flash_attention_cuda(
                   qp, kp, vp, **kw)),
               "fwd_plain_ms": time_ms(lambda: flash_attention_plain(
                   qp, kp, vp, **kw)),
               "fwd_library_ms": sdpa_ms,
               "fwd_flop_ms": fwd_flops / peaks["bfloat16"] * 1e3,
               "fwd_byte_ms": fwd_bytes / peaks["hbm"] * 1e3}
        row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
        row["fwd_bound_ms"] = max(row["fwd_flop_ms"], row["fwd_byte_ms"])
        rows[label] = row
        print(f"  flash forward / backward, {label} B={B} {Hq}/{Hkv}x{D} "
              f"{Sq} q over {Skv} keys (kernels see {Sq + pad_q} x "
              f"{Skv + pad_kv}, kv_len {kv_len}), causal {causal}, window "
              f"{window}: forward max |err| {fwd_errs[-1]:.2e} (2^-7), "
              f"backward {err:.2e} (one bf16 ulp + the f32 bound, worst "
              f"{worst:.3f} of it); forward ms={row['fwd_ms']:.4f} plain="
              f"{row['fwd_plain_ms']:.4f} SDPA={sdpa_ms:.4f} bound="
              f"{row['fwd_bound_ms']:.4f}; backward ms={row['ms']:.4f} "
              f"plain={row['plain_ms']:.4f} SDPA (fwd+bwd minus fwd)="
              f"{row['library_ms']:.4f} bound={row['bound_ms']:.4f}",
              flush=True)
        del out, lse, leaves
    return max(fwd_errs), max(bwd_errs), rows


# The training phases of the hybrid, ssm, audio and vlm families (5p-5s):
# (label, arch, depth cut or None).  Batch 8 x 512 tokens (448 for
# whisper, its decoder's positions), 8-bit AdamW moments; the vlm at 20
# of its 40 layers (4 cross layers) with its cross gates set to
# FAMILY_GATE (tanh(0) = 0 at init would leave every cross weight's
# gradient zero).
FAMILY_TRAIN = (("5p", "zamba2-7b", None), ("5q", "rwkv6-7b", None),
                ("5r", WHISPER, None), ("5s", VLM_ARCH, 20))
FAMILY_GATE = 0.5
# Step 0 against the plain path at full width and this depth: zamba2-7b's
# 7 layers hold both shared-attention applications' sum (layers 0 and
# 6).  At its 81 layers random weights amplify one-ulp differences until
# two plain versions differ by 0.14-0.79 of a leaf's largest gradient on
# the H100: a floor under which a lost gradient would pass.
STEP0_DEPTH = {"zamba2-7b": 7}
# The training attentions of each arch (TRAIN_ATTN labels), with their
# layers a step: (label, forward calls before remat, backward calls).
FAMILY_ATTN = {"zamba2-7b": (("zamba2-7b shared", 14, 14),),
               WHISPER: (("whisper encoder", 6, 6), ("whisper self", 6, 6),
                         ("whisper cross", 6, 6)),
               VLM_ARCH: (("vlm self", 20, 20), ("vlm cross", 4, 4))}


def family_cfg(arch, depth):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=depth) if depth else cfg


def family_params(cfg, device):
    """The seed's parameters, the vlm's cross gates at FAMILY_GATE."""
    import torch
    from repro_torch.models import init_params, param_defs
    params = init_params(param_defs(cfg),
                         torch.Generator(device).manual_seed(SEED))
    if "cross_blocks" in params:
        params["cross_blocks"]["gate"].fill_(FAMILY_GATE)
    return params


def family_seq(cfg) -> int:
    """Tokens a row: TRAIN_SEQ; whisper's decoder takes WHISPER_MAX_LEN
    (its learned positions' count in the served phase)."""
    return WHISPER_MAX_LEN if cfg.family == "audio" else TRAIN_SEQ


def family_batch(cfg, step: int, device) -> dict:
    """Batch ``step``: SyntheticLM (seed 0) tokens and labels, 8 x
    ``family_seq``, and for the vlm and audio families their extra input
    (8, rows, d_model) drawn from a seeded ``torch.Generator`` on the
    card, in the config's type."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import get_model
    data = SyntheticLM(vocab=cfg.vocab, seq_len=family_seq(cfg),
                       global_batch=TRAIN_BATCH, seed=0)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(step).items()}
    extra = get_model(cfg).extra_input
    if extra:
        rows = (cfg.n_vision_tokens if extra == "vision_embeds"
                else cfg.encoder_seq)
        gen = torch.Generator(device).manual_seed(SEED + 500 + step)
        batch[extra] = torch.randn((TRAIN_BATCH, rows, cfg.d_model),
                                   generator=gen, device=device).to(
            cfg.tdtype)
    return batch


class FamilyData:
    """The Trainer's data for 5r: ``family_batch`` as numpy arrays (the
    extra input in f32, which the step takes back to the config's type:
    bf16 -> f32 -> bf16 is exact)."""

    def __init__(self, cfg, device):
        self.cfg, self.device = cfg, device

    def batch_at(self, step, *args):
        return {k: v.float().cpu().numpy() if v.is_floating_point()
                else v.cpu().numpy()
                for k, v in family_batch(self.cfg, step, self.device).items()}


def family_launches(cfg, remat: bool) -> dict:
    """The kernel launches of one training step of ``cfg``: the scans once
    per layer (twice under remat), the flash forward once per attention
    (twice for those inside a rematerialised block: every zamba2 shared
    application, the decoder's self and cross in whisper, the vlm's self
    attention; never the vlm's cross blocks, outside the checkpoint, nor
    whisper's encoder) and the backward once per attention."""
    L, per = cfg.n_layers, 2 if remat else 1
    want = {k: 0 for k in ("flash_attention", "flash_attention_bwd",
                           "decode_attention", "paged_decode_attention",
                           "matmul", "mamba2_scan", "wkv6")}
    if cfg.family == "hybrid":
        e = cfg.shared_attn_every
        apps = -(-L // e) if e else 0
        want.update(mamba2_scan=per * L, flash_attention=per * apps,
                    flash_attention_bwd=apps)
    elif cfg.family == "ssm":
        want["wkv6"] = per * L
    elif cfg.family == "audio":
        E = cfg.n_encoder_layers
        want.update(flash_attention=E + per * 2 * L,
                    flash_attention_bwd=E + 2 * L)
    else:                                                  # vlm
        cross = L // cfg.cross_attn_every
        want.update(flash_attention=per * L + cross,
                    flash_attention_bwd=L + cross)
    return want


def _to_host(tree):
    from repro_torch.checkpoint import tree_leaves
    return [t.detach().to("cpu", copy=True) for t in tree_leaves(tree)]


def _host_equal(host, tree) -> bool:
    """``tree``'s leaves bit for bit against ``host`` copies, a leaf at a
    time on the card."""
    import torch
    from repro_torch.checkpoint import tree_leaves
    leaves = tree_leaves(tree)
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return len(host) == len(leaves) and all(
        h.dtype == t.dtype and torch.equal(bits(h.to(t.device)), bits(t))
        for h, t in zip(host, leaves))


def train_family(label, arch, device, depth=None):
    """Phases 5p-5s: ``arch`` trained at full width (``depth`` layers when
    cut) on its legacy forward through ``launch/steps.py`` in bf16, batch
    8, 8-bit AdamW moments, remat by the reference's rule (16 layers on).

    (a) Step 0's loss and gradients through the kernels against the plain
    path on the card (``step0_against_plain``: 5f's gates; for the
    recurrent families a floor from a second plain version, no leaf
    limit past FLOOR_CAP), at STEP0_DEPTH layers where the arch has one;
    (b) ``graphed_against_eager_steps``, the graphed step alone
    profiled, through ``runtime.Trainer`` for the audio family (its
    checkpoint is small; a 7B state's would be 27 GB): exactly
    ``family_launches`` per graphed step, every flash launch on mma,
    every loss finite, graphed and eager steps bit for bit.  Returns
    (launches, stats)."""
    import gc
    import math
    import torch
    from repro_torch.models import param_defs
    from repro_torch.optim import AdamW
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = family_cfg(arch, depth)
    remat = cfg.n_layers >= 16
    n = COMPARE_STEPS
    per_step = family_launches(cfg, remat)
    cut = (f"{cfg.n_layers} of {family_cfg(arch, None).n_layers} layers"
           if depth else "full depth")
    n_params = sum(math.prod(d.shape)
                   for d in _named_leaves(param_defs(cfg)).values())
    print(f"{label} {arch}: {n_params / 1e9:.3f} B parameters, "
          f"{cfg.n_layers} layers ({cut}), width {cfg.d_model}, batch "
          f"{TRAIN_BATCH} x {family_seq(cfg)}, remat {remat}, 8-bit "
          f"moments; per step {per_step}", flush=True)
    # (a) step 0 against the plain path, at STEP0_DEPTH layers if cut
    cfg0 = family_cfg(arch, STEP0_DEPTH.get(arch, depth))
    if cfg0.n_layers != cfg.n_layers:
        print(f"{label} step 0 at full width and {cfg0.n_layers} of "
              f"{cfg.n_layers} layers, remat {remat} (STEP0_DEPTH)")
    t0 = time.perf_counter()
    loss0 = step0_against_plain(
        label, cfg0, device, family_batch(cfg0, 0, device),
        params=family_params(cfg0, device), remat=remat,
        floor=cfg.family in ("hybrid", "ssm"))
    took(f"{label} step 0 against the plain path", t0)
    # (b) the compiled step against the eager one; an eager profile
    # would read only the device-busy share of a host-bound step
    cmp = graphed_against_eager_steps(label, cfg, device,
                                      AdamW(state_bits=8),
                                      profile_eager=False,
                                      data=(FamilyData(cfg, device)
                                            if cfg.family == "audio"
                                            else None))
    launches = cmp["launches"]
    want = {k: n * v for k, v in per_step.items()}
    print(f"{label} train: {n} steps, launches {launches}, want {want}")
    if launches != want:
        fail(f"{label}: launch counts {launches} != {want}")
    check_flash_paths(f"{label} train", want["flash_attention"],
                      want["flash_attention_bwd"], got=cmp["flash_paths"])
    losses = cmp["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite loss in {losses}")
    tokens = TRAIN_BATCH * family_seq(cfg)
    stats = {**cmp, "tok_s": tokens / (cmp["graphed_ms"] / 1e3),
             "loss0": loss0, "per_step": per_step, "params_b": n_params / 1e9,
             "cut": cut, "seconds": time.perf_counter() - t_phase}
    print(f"{label} {arch}: {stats['tok_s']:.0f} tokens/s trained; step "
          f"{cmp['graphed_ms']:.2f} ms graphed / {cmp['eager_ms']:.2f} ms "
          f"eager; peak memory allocated {cmp['peak_gb']:.2f} GB; losses "
          f"{[round(x, 4) for x in losses]}; phase "
          f"{stats['seconds']:.1f} s", flush=True)
    return launches, stats


# Device-time groups of a profiled training step, by kernel name.
# The port's serving kernels by name (csrc/*.cu), then the training
# step's groups for what else a served call launches.
SERVE_KERNELS = ("conv_kernel", "flash_kernel", "flash_mma_kernel",
                 "matmul_kernel", "skinny_", "split_kernel",
                 "splitk_reduce", "ssd_", "wgmma_bf16", "wkv_")
KERNEL_GROUPS = (("flash forward (CUDA)", ("flash_kernel",
                                             "flash_mma_kernel")),
                 ("flash backward (CUDA)", ("dq_kernel", "dkv_kernel",
                                            "dq_mma_kernel",
                                            "dkv_mma_kernel")),
                 ("NCCL collectives", ("nccl",)),
                 ("cuBLAS GEMMs", ("gemm", "gemv", "xmma", "cutlass",
                                   "cublas", "nvjet")),
                 ("reductions and softmax", ("reduce", "softmax",
                                             "logsumexp")),
                 ("index / scatter / gather", ("index", "scatter",
                                               "gather")),
                 ("recurrent scans (CUDA)", ("ssd_", "wkv_")))


SERVE_GROUPS = (("the port's kernels (CUDA)", SERVE_KERNELS),
                ) + KERNEL_GROUPS[2:]


def profile_train(label, call, step_ms):
    """One more training step (``call()``) under ``torch.profiler``:
    device time by kernel group, the device-busy share of the unprofiled
    step ``step_ms``, and the launches.  Prints "not measured" when the
    profiler sees no device time.  The device's activity alone is
    recorded: nothing here reads the host's ops, and sorting them beside
    a step of ~70k launches takes minutes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups, kernels, launches = Counter(), Counter(), 0
    for evt in prof.key_averages():
        if "CUDA" not in str(evt.device_type):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = evt.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other elementwise")
        groups[group] += us / 1e3
        kernels[f"{evt.key[:60]} x{evt.count}"] += us / 1e3
        launches += evt.count
    total = sum(groups.values())
    if total <= 0:
        print(f"{label} profile: the profiler saw no device time; "
              f"breakdown not measured")
        return None
    print(f"{label} profile: {wall_ms:.1f} ms under the profiler; "
          f"{launches} kernel launches, {total:.1f} ms of device time = "
          f"{100 * total / step_ms:.1f}% of the unprofiled {step_ms:.1f} ms "
          f"step (device idle {100 * (1 - total / step_ms):.1f}%): " +
          ", ".join(f"{g} {ms:.2f} ms" for g, ms in groups.most_common()))
    print(f"{label} profile, the ten largest kernels: " + "; ".join(
        f"{k} {ms:.2f} ms" for k, ms in kernels.most_common(10)))
    return {"device_ms": total, "launches": launches, "groups": dict(groups),
            "wall_ms": wall_ms, "busy": total / step_ms}


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in sorted(tree.items())
                for k2, v2 in _named_leaves(v, f"{prefix}/{k}"
                                            if prefix else k).items()}
    return {prefix: tree}


def lm_sums(rows, uses, pname, kind, kernel):
    """Times and bounds of ``kernel`` summed over one run of the
    (``pname``, ``kind``) Program, each op counted once."""
    out = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "flop_ms", "byte_ms")}
    n = 0
    for desc, count in uses[(pname, kind)].items():
        if rows[desc]["kernel"] != kernel:
            continue
        n += count
        for k in out:
            out[k] += count * rows[desc][k]
    out["launches"] = n
    return out


class Recorder:
    """Wraps the executor's graphed runners and page-table hand-offs
    while a main path runs: every runner an engine makes inside the
    ``with`` records each call's inputs, in order, with the logits rows
    the engine reads (a CNN run: its whole output) and the call's wall
    time up to a device synchronise (page-table syncs and COW copies
    are kept to be replayed, untimed).  An audio engine's admission-time
    encoder memory writes are recorded too ("memory": the slot and the
    request's frames, timed to a device synchronise) and replayed, the
    encoder through the replay's own path."""

    RUNNERS = {"graphed_prefill_runner": "prefill",
               "graphed_chunk_runner": "chunk",
               "graphed_decode_runner": "decode",
               "graphed_runner": "run"}
    NAMES = tuple(RUNNERS) + ("sync_page_table", "apply_page_copies")

    def __init__(self):
        from repro_torch.runtime import executor
        self.ex = executor
        self.orig = {n: getattr(executor, n) for n in self.NAMES}
        self.calls = []

    def _record(self, kind, dt, args, out):
        import numpy as np
        if kind == "prefill":
            _, tokens, _, slot, length, write_from = args
            self.calls.append(("prefill", dt, (tokens.clone(), slot, length,
                                               write_from),
                               {0: out[0, length - 1].clone()}))
        elif kind == "chunk":
            tokens, rest = args[1], args[3:]
            vecs = tuple(np.array(x) for x in rest)
            self.calls.append(("chunk", dt, (tokens.clone(),) + vecs, {
                i: out[i, n - 1].clone() for i, (s, n) in
                enumerate(zip(vecs[2], vecs[3])) if s == n}))
        elif kind == "decode":
            tokens, mask = args[1], args[3]
            self.calls.append(("decode", dt, (tokens.clone(), mask.clone()),
                               {i: out[i].clone() for i in
                                mask.nonzero().flatten().tolist()}))
        else:
            self.calls.append(("run", dt, (), {0: out.clone()}))

    def __enter__(self):
        import torch
        from repro_torch.serving.engine import ServingEngine
        orig = self.orig
        self.engine_cls = ServingEngine
        self.orig_memory = ServingEngine._write_encoder_memory
        rec = self

        def write_memory(eng, slot, req):
            t0 = time.perf_counter()
            rec.orig_memory(eng, slot, req)
            torch.cuda.synchronize()
            rec.calls.append(("memory", time.perf_counter() - t0,
                              (slot, torch.from_numpy(req.extra)), {}))
        ServingEngine._write_encoder_memory = write_memory

        def wrap(name, kind):
            def factory(program, impl="auto"):
                runner = orig[name](program, impl=impl)

                def call(*args):
                    t0 = time.perf_counter()
                    out = runner(*args)
                    torch.cuda.synchronize()
                    self._record(kind, time.perf_counter() - t0, args, out)
                    return out
                call.store = getattr(runner, "store", None)   # CNN runs
                return call
            return factory

        def sync_page_table(state, pair, pool):
            if pool.dirty:
                self.calls.append(("table", 0.0, pool.table.copy(), {}))
            return orig["sync_page_table"](state, pair, pool)

        def apply_page_copies(state, pair, copies):
            if copies:
                self.calls.append(("copies", 0.0, list(copies), {}))
            return orig["apply_page_copies"](state, pair, copies)
        wrappers = {name: wrap(name, kind)
                    for name, kind in self.RUNNERS.items()}
        wrappers.update(sync_page_table=sync_page_table,
                        apply_page_copies=apply_page_copies)
        for n, fn in wrappers.items():
            setattr(self.ex, n, fn)
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.ex, n, fn)
        self.engine_cls._write_encoder_memory = self.orig_memory

    def count(self, kind: str) -> int:
        return sum(c[0] == kind for c in self.calls)

    def ms(self, kind: str, stat=statistics.mean) -> float | None:
        times = [c[1] for c in self.calls if c[0] == kind]
        return 1e3 * stat(times) if times else None

    def rows(self) -> list:
        return [(i, c[0], c[3]) for i, c in enumerate(self.calls)
                if c[0] in ("prefill", "chunk", "decode", "run")]

    def _plain_rows(self, eng, impl: str = "reference",
                    routes: list | None = None):
        """The recorded calls again, in order, through the plain path
        (``impl``: "auto" for the kernel path, eagerly) on a fresh state,
        teacher-forced with the kernel path's inputs and page-table
        decisions.  Returns, per recorded call that produced logits,
        (kind, {row: the replay's logits row}).  ``routes``, a list,
        gets each such call's MoE routing (``routing``): per MoE op, each
        token's sorted top-k expert ids."""
        import torch
        orig, pair = self.orig, eng.program
        state = self.ex.init_program_state(pair, eng.device)
        rows = []
        for kind, _, args, got in self.calls:
            if kind == "table":
                state.caches[pair.page_table_region].copy_(
                    torch.from_numpy(args))
                continue
            if kind == "copies":
                orig["apply_page_copies"](state, pair, args)
                continue
            if kind == "memory":
                write_memory(eng, state, *args, impl=impl)
                continue
            tokens, args = args[0].to(eng.device), args[1:]
            log = []
            with routing(log) if routes is not None else \
                    contextlib.nullcontext():
                if kind == "prefill":
                    slot, length, write_from = args
                    out = self.ex.run_prefill(pair.prefill, eng.params,
                                              tokens, state, slot, length,
                                              write_from, impl=impl)
                    want = {0: out[0, length - 1]}
                elif kind == "chunk":
                    slot, start, stop, length, write_from = args
                    out = self.ex.run_prefill_chunk(
                        pair.prefill, eng.params, tokens, state, slot,
                        start, stop, length, write_from, impl=impl)
                    want = {i: out[i, length[i] - 1] for i in got}
                else:
                    mask = args[0].to(eng.device)
                    out = self.ex.run_decode(pair.decode, eng.params,
                                             tokens, state, mask, impl=impl)
                    want = {i: out[i] for i in got}
            if routes is not None:
                routes.append(log)
            rows.append((kind, {i: want[i].float().cpu().numpy()
                                for i in got}))
        return rows

    def replay_plain(self, eng, arch: str):
        """Every served logits row against the plain replay's, within the
        bound; the served token must equal the plain one wherever the
        plain top-2 gap exceeds twice the row's largest difference.

        For a recurrent family (``FAMILY_FLOOR``) the calls are replayed a
        second time with the recurrence as its sequential f32 oracle:
        the bound is then max(``LOGIT_TOL``, twice the largest difference
        between the two plain replays), for a model whose depth amplifies
        one-ulp differences past any fixed bound, and the mean |logit
        diff| over the rows must stay within ``FAMILY_MEAN_TOL``.
        Returns (max |logit diff|, rows compared, token ids compared,
        the two plain replays' largest difference or None, the bound) and
        prints the mean |logit diff| of each comparison."""
        moe = arch == MOE_ARCH
        routes = [] if moe else None
        plain = self._plain_rows(eng, routes=routes)
        spread, bound, note, mean_tol = None, LOGIT_TOL, "", None
        if arch in FAMILY_FLOOR or moe:
            with (reordered_plain() if moe
                  else sequential_plain(*FAMILY_FLOOR[arch])):
                alt = self._plain_rows(eng)
            bound, plain_mean, spread = plain_floor(
                (a[i], b[i]) for (_, a), (_, b) in zip(plain, alt)
                for i in a)
            mean_tol = FAMILY_MEAN_TOL.get(arch, 2 * plain_mean)
            note = f"; between the two plain replays {plain_mean:.4f}"
        served = [c for c in self.calls
                  if c[0] in ("prefill", "chunk", "decode")]
        if moe:
            self.routing_report(eng, served, plain, routes)
        worst, mean, n_rows, n_ids, largest = hold_rows(
            "served", ((kind, g.float().cpu().numpy(), want[i])
                       for (kind, want), (_, _, _, got) in zip(plain,
                                                                served)
                       for i, g in got.items()), bound, mean_tol)
        print(f"  mean |logit diff| per row: served against plain "
              f"{mean:.4f} (largest row {largest:.4f}){note}"
              + (f"; limit {mean_tol:.4f}" if mean_tol else ""))
        return worst, n_rows, n_ids, spread, bound

    def routing_report(self, eng, served, plain, routes) -> None:
        """The recorded calls replayed once more through the kernel path,
        eagerly, recording its routing: its rows against the served ones
        (the graphs replay what the eager calls compute), and the rows
        whose routing differs from the plain replay's at some MoE layer
        (a decode row: its own token; an admission's row: any prompt
        token), with the largest and mean |logit diff| of the rows routed
        alike and of those routed otherwise, printed."""
        import numpy as np
        k_routes = []
        kern = self._plain_rows(eng, impl="auto", routes=k_routes)
        eager_diff = max(float(np.abs(
            g[i].float().cpu().numpy() - k[i]).max())
            for (_, _, _, g), (_, k) in zip(served, kern) for i in g)
        same, other = [], []
        for (kind, _, args, got), (_, want), a, b in zip(
                served, plain, k_routes, routes):
            for i in got:
                tok = slice(0, int(args[2])) if kind == "prefill" else i
                flip = any(not np.array_equal(x[tok], y[tok])
                           for x, y in zip(a, b))
                diff = np.abs(got[i].float().cpu().numpy() - want[i])
                (other if flip else same).append(diff)
        stat = lambda ds: (f"{len(ds)} rows, largest {max(d.max() for d in ds):.4f}, "
                           f"mean {np.mean([d.mean() for d in ds]):.4f}"
                           if ds else "0 rows")
        print(f"  routing: served rows against an eager kernel-path replay "
              f"{eager_diff:.3e}; rows whose routing differs from the plain "
              f"path's at some MoE layer: {stat(other)}; routed alike: "
              f"{stat(same)}", flush=True)

    def prefill_tenures(self) -> list[tuple[int, int, int]]:
        """(slot, prompt length, chunk calls from its first chunk to its
        last) of every chunked prefill.  While any prefill is in flight
        the engine makes one chunk call per tick, so the count is the
        ticks from slot assignment to the first token."""
        first, out = {}, []
        chunks = [c[2] for c in self.calls if c[0] == "chunk"]
        for k, (_, slot, _, stop, length, _) in enumerate(chunks):
            for s, e, n in zip(slot.tolist(), stop.tolist(),
                               length.tolist()):
                first.setdefault(s, k)
                if e == n:
                    out.append((s, n, k - first.pop(s) + 1))
        return out


def write_memory(eng, state, slot: int, frames, impl: str) -> None:
    """An audio admission's memory write on ``state``: the encoder and
    cross K/V projection of ``frames`` through ``impl`` ("reference": the
    plain path), the rows copied into the read-only regions at
    ``slot``."""
    from repro_torch.models import get_model
    writer = get_model(eng.cfg).encode_memory
    rows = writer(eng.params, frames.to(eng.device, eng.cfg.tdtype),
                  eng.cfg, impl=impl)
    for name, row in rows.items():
        state.caches[eng.program.persistent[name]][slot].copy_(row)


@contextlib.contextmanager
def op_outputs(ex, outs: list):
    """Inside, every op the executor dispatches appends (op name, its
    output) to ``outs``; under capture the outputs are the graph's own
    buffers, which a replay fills."""
    names = ("_run_op", "_run_attention", "_run_attention_chunk",
             "_run_family_op", "_run_moe", "_run_decode_attention",
             "_run_decode_attention_paged", "_run_cross_attention")
    orig = {n: getattr(ex, n) for n in names}

    def wrap(fn):
        def recorded(op, *args, **kw):
            out = fn(op, *args, **kw)
            outs.append((op.name, out[0] if isinstance(out, tuple) else out))
            return out
        return recorded
    for n, fn in orig.items():
        setattr(ex, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(ex, n, fn)


def first_differing_op(eng, rec, idx: int):
    """Recorded call ``idx`` once eagerly and once through a captured
    CUDA graph, on two copies of the state that the calls before it
    leave (replayed eagerly, teacher-forced with the recorded inputs and
    page-table decisions), every op's output recorded on both sides.
    Returns (op name, max |diff|) of the first op whose outputs differ,
    or None when all agree bit for bit."""
    import torch
    ex, pair, params, dev = rec.ex, eng.program, eng.params, eng.device
    state = ex.init_program_state(pair, dev)

    def ints(*xs):
        return [torch.as_tensor(x, dtype=torch.int32, device=dev).reshape(-1)
                for x in xs]

    def call(st, c):
        """(fn, inputs) of a recorded Program run on state ``st``; a
        table sync or page copy is applied and gives None."""
        kind, _, args, _ = c
        if kind == "table":
            st.caches[pair.page_table_region].copy_(torch.from_numpy(args))
            return None
        if kind == "copies":
            ex.apply_page_copies(st, pair, args)
            return None
        if kind == "memory":
            write_memory(eng, st, *args, impl="auto")
            return None
        tokens = args[0].to(dev)
        if kind == "prefill":
            return (lambda t, *v: ex.run_prefill(
                pair.prefill, params, t, st, *v), [tokens, *ints(*args[1:])])
        if kind == "chunk":
            return (lambda t, *v: ex.run_prefill_chunk(
                pair.prefill, params, t, st, *v), [tokens, *ints(*args[1:])])
        return (lambda t, m: ex.run_decode(pair.decode, params, t, st, m),
                [tokens, args[1].to(dev)])

    for c in rec.calls[:idx]:
        run = call(state, c)
        if run is not None:
            run[0](*run[1])
    twin = ex.ProgramState({r: t.clone() for r, t in state.caches.items()},
                           state.lengths.clone())
    eager, graphed = [], []
    fn, inputs = call(state, rec.calls[idx])
    with op_outputs(ex, eager):
        fn(*inputs)
    gfn, ginputs = call(twin, rec.calls[idx])
    with op_outputs(ex, graphed):
        graph = ex._Graph(gfn, ginputs, twin.graphs)
    graph(ginputs)
    torch.cuda.synchronize()
    for (name, a), (_, b) in zip(eager, graphed):
        if not torch.equal(a, b):
            return name, (a.float() - b.float()).abs().max().item()
    return None


def graphed_against_eager(label, capture_s: float, rec, erec, eng_eager,
                          exact: bool, bound: float = 0.0) -> dict:
    """The graphed main path's recorded calls against the same requests
    served under ``executor.disable_graphs()``: the same calls in the
    same order, each logits row bitwise equal (``exact``: no cuBLAS on
    the path) or within ``bound`` (the teacher-forced replay's gate),
    with the largest difference and, where a row differs, the first op
    that differs.  Prints both runs' served ms per call and the capture
    seconds; returns them.  ``eng_eager`` (an LM engine, or None) runs
    the op-by-op search for the first differing op."""
    import numpy as np
    got, want = rec.rows(), erec.rows()
    if [(k, sorted(r)) for _, k, r in got] != [(k, sorted(r))
                                                for _, k, r in want]:
        fail(f"{label}: graphed and eager serving made other calls")
    worst, first, n_rows = 0.0, None, 0
    for (i, kind, g), (_, _, e) in zip(got, want):
        for r in g:
            a, b = g[r].float().cpu().numpy(), e[r].float().cpu().numpy()
            diff = float(np.abs(a - b).max())
            n_rows += 1
            if diff or not np.array_equal(a, b):
                worst = max(worst, diff)
                first = i if first is None else first
    where = ""
    if first is not None and eng_eager is not None:
        op = first_differing_op(eng_eager, rec, first)
        where = (f"; first at call {first} ({rec.calls[first][0]}), first "
                 f"differing op: " + (f"{op[0]} by {op[1]:.3e}" if op else
                                      "none (the op-by-op rerun agrees)"))
    print(f"{label}: graphed against eager (disable_graphs) serving: "
          f"{n_rows} logits rows, largest difference {worst:.3e}{where}",
          flush=True)
    if exact and first is not None:
        fail(f"{label}: graphed logits rows are not bitwise equal to the "
             f"eager ones")
    if worst > bound:
        fail(f"{label}: graphed logits rows differ from the eager ones by "
             f"{worst:.3e} > {bound:.3e}")
    kinds = [k for k in ("run", "prefill", "chunk", "decode")
             if rec.count(k)]
    out = {"capture_s": capture_s}
    for k in kinds:
        for side, r in (("graphed", rec), ("eager", erec)):
            out[f"{side}_{k}_ms"] = r.ms(k)
            out[f"{side}_{k}_median_ms"] = r.ms(k, statistics.median)
    print(f"{label}: served ms per call, graphed / eager: " + "; ".join(
        f"{k} mean {out[f'graphed_{k}_ms']:.3f} / {out[f'eager_{k}_ms']:.3f}"
        f", median {out[f'graphed_{k}_median_ms']:.3f} / "
        f"{out[f'eager_{k}_median_ms']:.3f} ({rec.count(k)} calls)"
        for k in kinds) + f"; capture {out['capture_s']:.3f} s", flush=True)
    return out


def served(stats, kind: str, kernel_ms: float | None = None) -> str:
    """The served ms per call of ``kind``, graphed and eager (medians:
    the steady state, past the first call's build and the capture), and
    the device-busy share of the graphed median (the kernel sum over
    it)."""
    g = stats[f"graphed_{kind}_median_ms"]
    e = stats[f"eager_{kind}_median_ms"]
    busy = (f", device busy {100 * kernel_ms / g:.1f}% of the graphed"
            if kernel_ms else "")
    return f"served {g:.3f} ms graphed / {e:.3f} ms eager (medians{busy})"


def profile_replays(label, call, served_ms: float, n: int = 3):
    """``n`` more calls of a captured graph (``call()`` replays it)
    under ``torch.profiler``: kernels and device ms per call by group,
    and the device-busy share of the unprofiled graphed median
    ``served_ms``.  Prints "not measured" when the profiler sees no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    groups, launches = Counter(), 0
    for evt in prof.key_averages():
        if "CUDA" not in str(evt.device_type):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = evt.key.lower()
        group = next((g for g, keys in SERVE_GROUPS
                      if any(k in name for k in keys)), "other elementwise")
        groups[group] += us / 1e3 / n
        launches += evt.count
    total = sum(groups.values())
    if total <= 0:
        print(f"{label} profile: the profiler saw no device time; "
              f"breakdown not measured")
        return None
    print(f"{label} profile: {launches // n} kernels and {total:.3f} ms of "
          f"device time a call ({wall_ms:.3f} ms a call under the "
          f"profiler) = {100 * total / served_ms:.1f}% of the unprofiled "
          f"graphed median {served_ms:.3f} ms (device idle "
          f"{100 * (1 - total / served_ms):.1f}%): " + ", ".join(
              f"{g} {ms:.3f} ms" for g, ms in groups.most_common()),
          flush=True)
    return {"device_ms": total, "kernels": launches // n,
            "groups": dict(groups), "busy": total / served_ms}


def check_captured(label, graphs: dict, kinds) -> int:
    """The main path ran off captured CUDA graphs: each kind in
    ``kinds`` has one.  Returns the number captured."""
    captured = [k for k, g in graphs.items() if g is not None]
    for kind in kinds:
        if not any(kind in k for k in captured):
            fail(f"{label}: no CUDA graph was captured for {kind}")
    return len(captured)


def serve_eager(run):
    """``run()`` again under ``executor.disable_graphs()``, recorded."""
    from repro_torch.runtime import executor
    with executor.disable_graphs(), Recorder() as rec:
        res = run()
    return res, rec


def lm_counters():
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda, paged_decode_attention_cuda)
    from repro_torch.kernels.flash_attention.bwd_kernel import (
        flash_attention_bwd_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.mamba2.kernel import mamba2_scan_cuda
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    from repro_torch.kernels.rwkv6.kernel import wkv6_cuda
    return {"flash_attention": flash_attention_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda,
            "decode_attention": decode_attention_cuda,
            "paged_decode_attention": paged_decode_attention_cuda,
            "matmul": matmul_cuda, "mamba2_scan": mamba2_scan_cuda,
            "wkv6": wkv6_cuda}


def serve_lm(label: str, run, n_requests: int, max_new: int = 32,
             arch: str = LM_ARCH):
    """Phases 5b-5e, 5g, 5h: one LM main path (``run()`` calls the
    serving entry point and returns its result), counters set to 0 just
    before it and read just after, under the Recorder; then the exact
    launch counts (``PAIR_OPS[arch]`` per call), every request served in
    full with no prefill recomputed, and the teacher-forced plain replay
    (``Recorder.replay_plain``).  Returns (launches, stats, engine,
    recorder)."""
    counters = lm_counters()
    for fn in counters.values():
        fn.launches = 0
    reset_matmul_paths()
    reset_flash_paths()
    counters["matmul"].b_transposed_launches = 0
    with Recorder() as rec:
        res = run()
    launches = {k: fn.launches for k, fn in counters.items()}
    bt_launches = counters["matmul"].b_transposed_launches
    eng, done = res["engine"], res["done"]
    if len(done) != n_requests or not all(
            r.done and len(r.out_tokens) == max_new for r in done):
        fail(f"{label}: served {len(done)} of {n_requests} requests in full")
    if eng.n_prefill_recomputes or eng.n_prefills != n_requests:
        fail(f"{label}: prefills {eng.n_prefills}, recomputes "
             f"{eng.n_prefill_recomputes}")
    pre, dec = (Counter(op.kernel for op in prog.ops
                        if op.kernel in KERNEL_OPS)
                for prog in (eng.program.prefill, eng.program.decode))
    ticks = eng.n_decode_ticks
    passes = rec.count("prefill") + rec.count("chunk")
    paged = eng.program.paged is not None
    if rec.count("decode") != ticks:
        fail(f"{label}: {rec.count('decode')} decode calls, {ticks} ticks")
    # A cross op runs the flash kernel in a prefill and the decode kernel
    # in a tick; an audio admission runs the encoder once (one flash
    # launch a layer) before its prefill.
    encodes = rec.count("memory")
    if encodes != (n_requests if eng.cfg.n_encoder_layers else 0):
        fail(f"{label}: {encodes} encoder memory writes for {n_requests} "
             f"requests")
    want = {"flash_attention": passes * (pre["flash_attention"]
                                         + pre["cross_attention"])
            + encodes * eng.cfg.n_encoder_layers,
            "flash_attention_bwd": 0,
            "decode_attention": 0 if paged else ticks * (
                dec["decode_attention"] + dec["cross_attention"]),
            "paged_decode_attention": (ticks * dec["decode_attention"]
                                       if paged else 0),
            "matmul": passes * pre["matmul"] + ticks * dec["matmul"],
            "mamba2_scan": passes * pre["ssm_scan"] + ticks * dec["ssm_scan"],
            "wkv6": passes * pre["wkv"]}      # the decode step is plain
    print(f"{label}: {rec.count('prefill')} prefill calls, "
          f"{rec.count('chunk')} chunk calls, {ticks} decode ticks, kernel "
          f"ops per call {dict(pre)} / {dict(dec)}; launches {launches}, "
          f"want {want}")
    if (launches != want
            or (dict(pre), dict(dec)) != PAIR_OPS[arch]):
        fail(f"{label}: launch counts {launches} != {want}, or ops per "
             f"call not {PAIR_OPS[arch]}")
    # Decode ticks (M = slots) on skinny, admissions and chunks (M =
    # max_len rows per prompt) on wgmma; a product whose K or N is not a
    # whole number of 16-byte vectors (granite's 49155-wide head) on simt.
    paths = Counter()
    for n_calls, prog, M in ((passes, eng.program.prefill, eng.max_len),
                             (ticks, eng.program.decode, eng.slots)):
        for path, k in matmul_paths(eng.cfg, prog, M).items():
            paths[path] += n_calls * k
    check_matmul_paths(label, paths["skinny"], paths["wgmma"],
                       paths["simt"])
    # A tied bf16 head reads the embedding transposed, once per Program
    # run.
    n_tied = sum(op.transpose_w for op in eng.program.decode.ops
                 if eng.cfg.dtype == "bfloat16")
    if bt_launches != n_tied * (passes + ticks):
        fail(f"{label}: {bt_launches} matmul launches read B transposed, "
             f"want {n_tied * (passes + ticks)}")
    # Every served flash call is bf16 on aligned views: the mma path.
    check_flash_paths(label, want["flash_attention"], 0)
    n_graphs = check_captured(label, eng.state.graphs.graphs,
                              ("prefill", "decode")
                              if rec.count("prefill") > 1 else ("decode",))
    print(f"{label}: {n_graphs} CUDA graphs captured in "
          f"{eng.capture_seconds:.3f} s")
    t0 = time.perf_counter()
    worst, n_rows, n_ids, spread, bound = rec.replay_plain(eng, arch)
    took(f"{label} plain replay", t0)
    n_tok = sum(len(r.out_tokens) for r in done)
    stats = {"tok_s": n_tok / res["seconds"], "seconds": res["seconds"],
             "tokens": n_tok, "prefill_ms": rec.ms("prefill"),
             "chunk_ms": rec.ms("chunk"), "tick_ms": rec.ms("decode"),
             "prefills": rec.count("prefill"), "chunks": rec.count("chunk"),
             "ticks": ticks, "worst_logit_diff": worst,
             "plain_spread": spread, "logit_bound": bound,
             "streams": [r.out_tokens for r in done],
             "prompts": res["prompts"], "capture_s": eng.capture_seconds}
    per_call = " ".join(f"{k} {stats[k + '_ms']:.2f} ms per call,"
                        for k in ("prefill", "chunk") if stats[k + "_ms"])
    floor_note = ("" if spread is None else
                  f" = max({LOGIT_TOL}, 2 x {spread:.3e}, the largest "
                  f"difference between two plain replays)")
    print(f"{label}: {n_rows} logits rows within {worst:.3e} of the plain "
          f"path (bound {bound:.3e}{floor_note}); {n_ids} token ids "
          f"compared, all "
          f"equal; {stats['tok_s']:.1f} tok/s ({n_tok} tokens in "
          f"{res['seconds']:.3f} s); {per_call} decode tick "
          f"{stats['tick_ms']:.2f} ms mean", flush=True)
    if label == "5b" or arch != LM_ARCH:
        t0 = time.perf_counter()
        stats["profile"] = profile_lm(label, eng, rec)
        took(f"{label} profile", t0)
    if encodes:
        stats["encoder_ms"] = rec.ms("memory")
        stats["encoder_median_ms"] = rec.ms("memory", statistics.median)
    if arch == LM_ARCH:
        stats.update(check_eager(label, run, stats, rec, exact=True))
        if stats["graphed_decode_median_ms"] >= stats[
                "eager_decode_median_ms"]:
            fail(f"{label}: the graphed decode tick is not faster than the "
                 f"eager one")
    return launches, stats, eng, rec


def profile_lm(label, eng, rec) -> dict:
    """A captured decode tick (every slot dead: the same work) and a
    captured admission (slot 0, a full-length prompt) replayed on the
    served engine's state under ``profile_replays``, against the
    graphed medians of the served calls."""
    import torch
    from repro_torch.runtime import executor
    pair, state, params = eng.program, eng.state, eng.params
    dec = executor.graphed_decode_runner(pair.decode, impl=eng.impl)
    toks = torch.zeros((eng.slots,), dtype=torch.int32)
    dead = torch.zeros((eng.slots,), dtype=torch.bool)
    out = {"decode": profile_replays(
        f"{label} decode tick", lambda: dec(params, toks, state, dead),
        rec.ms("decode", statistics.median))}
    if rec.count("prefill") > 1:
        pre = executor.graphed_prefill_runner(pair.prefill, impl=eng.impl)
        tokens = torch.zeros((1, eng.max_len), dtype=torch.int32)
        out["prefill"] = profile_replays(
            f"{label} admission",
            lambda: pre(params, tokens, state, 0, eng.max_len, 0),
            rec.ms("prefill", statistics.median))
    return out


def check_eager(label, run, stats, rec, exact: bool, bound: float = 0.0):
    """The main path's requests served again eagerly
    (``serve_eager``): identical greedy streams, and the logits rows
    held by ``graphed_against_eager``.  Frees the eager engine."""
    import gc
    import torch
    res, erec = serve_eager(run)
    if [r.out_tokens for r in res["done"]] != stats["streams"]:
        fail(f"{label}: the graphed and eager greedy streams differ")
    out = graphed_against_eager(label, stats["capture_s"], rec, erec,
                                res["engine"], exact, bound)
    del res, erec
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_paged(label: str):
    """Phases 5c-5e on the paged plan, each with its own requirement on
    the engine's page, admission and chunk counters."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    n = int(LM_ARGS[LM_ARGS.index("--requests") + 1])
    if label == "5d int8":
        run = lambda: serve.serve_lm(
            get_config(LM_ARCH), slots=SLOTS, max_len=LM_MAX_LEN,
            requests=n, max_new=32, seed=SEED, **PAGED_5D)
    else:
        run = lambda: serve.main(LM_ARGS + PAGED_RUNS[label])
    if label == "5e chunked":
        n += 1                                  # the long prompt
    launches, stats, eng, rec = serve_lm(label, run, n)
    adm = eng.admission
    stats.update(shared_pages=eng.n_shared_pages, cow_forks=eng.n_cow_forks,
                 requeued=adm.n_requeued,
                 pages_exhausted=adm.blocked["pages_exhausted"],
                 starved_ticks=eng.n_starved_ticks,
                 prefill_chunks=eng.n_prefill_chunks)
    print(f"{label}: shared_pages={eng.n_shared_pages} "
          f"cow_forks={eng.n_cow_forks} requeued={adm.n_requeued} "
          f"blocked={dict(adm.blocked)} prefill_chunks="
          f"{eng.n_prefill_chunks} starved_ticks={eng.n_starved_ticks}")
    if not (eng.n_shared_pages > 0 and eng.n_cow_forks > 0):
        fail(f"{label}: no shared pages or no COW fork")
    if label == "5d int8" and not (adm.n_requeued > 0 and
                                   adm.blocked["pages_exhausted"] > 0):
        fail(f"{label}: the pool never ran out at admission")
    if label == "5e chunked":
        tenures = rec.prefill_tenures()
        late = [t for t in tenures if t[2] > -(-t[1] // eng.chunk_size)]
        print(f"{label}: {len(tenures)} chunked prefills, ticks from slot "
              f"assignment to first token (slot, length, ticks): "
              f"{tenures}")
        if eng.n_starved_ticks or late or len(tenures) != n:
            fail(f"{label}: starved ticks {eng.n_starved_ticks}, prefills "
                 f"past ceil(length / {eng.chunk_size}) ticks: {late}")
    return launches, stats


@contextlib.contextmanager
def reordered_plain():
    """Inside, the plain path sums in another order: the matmul's K
    products in two halves, each in f32, then added; the flash forward's
    keys in chunks of 64 (its online softmax over 8 chunks of a 512-row
    prompt instead of one).  A second plain version of the same
    functions."""
    import functools
    import torch
    from repro_torch.kernels.common import apply_activation
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.matmul import ops
    orig = ops.matmul_ref, flash_ops.flash_ref

    def halves(a, b, *, bias=None, activation=None, bypass=None):
        h = a.shape[-1] // 2
        acc = (torch.matmul(a[..., :h].float(), b[:h].float())
               + torch.matmul(a[..., h:].float(), b[h:].float()))
        if bias is not None:
            acc = acc + bias.float()
        acc = apply_activation(acc, activation)
        if bypass is not None:
            acc = acc + bypass.float()
        return acc.to(a.dtype)
    ops.matmul_ref = halves
    flash_ops.flash_ref = functools.partial(orig[1], chunk=64)
    try:
        yield
    finally:
        ops.matmul_ref, flash_ops.flash_ref = orig


@contextlib.contextmanager
def routing(log: list):
    """Inside, each MoE dispatch appends its tokens' top-k expert ids
    (sorted; host tensors) to ``log``."""
    import torch
    from repro_torch.models import moe
    orig = moe.moe_mlp

    def recorded(x, router_w, *args, top_k, **kw):
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        log.append(torch.topk(probs, top_k, dim=-1).indices.sort(-1)
                   .values.cpu().numpy())
        return orig(x, router_w, *args, top_k=top_k, **kw)
    moe.moe_mlp = recorded
    try:
        yield
    finally:
        moe.moe_mlp = orig


@contextlib.contextmanager
def sequential_plain(module: str, fn: str):
    """Inside, the plain path of ``repro_torch.models.<module>`` runs its
    recurrence ``fn`` as the sequential f32 oracle (``impl="sequential"``)
    instead of the chunked form: a second plain version that sums in
    another order."""
    import importlib
    mod = importlib.import_module(f"repro_torch.models.{module}")
    orig = getattr(mod, fn)

    def swapped(*args, impl="auto", **kw):
        return orig(*args, impl="sequential" if impl == "reference" else impl,
                    **kw)
    setattr(mod, fn, swapped)
    try:
        yield
    finally:
        setattr(mod, fn, orig)


def _held(got, want, what: str, errs: dict, kernel: str,
          block: bool = False) -> None:
    """``got`` against ``want``: bf16 at atol = rtol = 2^-7 (phase 4's
    rule), f32 at 1e-4; a recurrent block's output (``block``) at 2^-7 of
    its largest magnitude.  That block composes its kernel's y (within
    the bf16 rule of the plain version) with a gated norm, a d_inner-wide
    projection and the residual add, plain torch on both sides, so a
    one-ulp difference in y reaches an output element through thousands
    of terms and may move a small one by more than its own ulps.  The
    largest |err| is kept per kernel in ``errs``."""
    import torch
    tol = BF16_TOL if want.dtype == torch.bfloat16 else TOL
    if block:
        got, want = got.float(), want.float()
        err, top = (got - want).abs().max().item(), want.abs().max().item()
        if not torch.isfinite(got).all() or err > tol * top:
            fail(f"{what}: the block's output differs from the plain "
                 f"path's by {err:.3e} > 2^-7 x its largest magnitude "
                 f"{top:.3e}")
    else:
        try:
            err = max_err(got, want, tol)
        except SystemExit as e:
            fail(f"{what}: {str(e).removeprefix('chip_smoke: FAIL: ')}")
    errs[kernel] = max(errs.get(kernel, 0.0), err)


def check_family_ops(label: str, eng, rec, arch: str) -> None:
    """Phases 5g, 5h and 5j, op by op: every admission the engine made before
    its first decode tick, then that tick, replayed from the recorded
    calls.  Each op whose kernel the kernel path launches (matmul,
    attention, the coarse recurrent block) runs once through the kernel
    path and once through the plain path on the plain path's input, and
    the two outputs are held to each other (``_held``); so are the
    recurrent states each block writes (the kernel side into copies of
    the regions it reads), live slots only at a tick.  The plain path's
    output and state go on to the next op.  The recurrence's plain
    version is its sequential f32 oracle, the function its kernel
    computes (the chunked form rounds its decay tile to bf16).  An MoE
    dispatch (5j) runs twice on the plain path's input (it is plain torch
    on both paths) and must agree bit for bit."""
    import torch
    ex, pair, params = rec.ex, eng.program, eng.params
    state = ex.init_program_state(pair, eng.device)
    errs, n_ops = {}, Counter()

    def family(op, src, where, **kw):
        mine = {r: state.caches[r].clone() for r in op.state_regions}
        got = ex._run_family_op(op, src, params, mine, impl="cuda", **kw)
        out = ex._run_family_op(op, src, params, state.caches,
                                impl="reference", **kw)
        for r in op.state_regions:
            rows = (kw["slot"] if "slot" in kw
                    else kw["live"].nonzero().flatten())
            _held(mine[r][rows], state.caches[r][rows],
                  f"{where} {op.name} state {r}", errs, op.kernel)
        return got, out

    n_adm = 0
    with (sequential_plain(*FAMILY_FLOOR[arch]) if arch in FAMILY_FLOOR
          else contextlib.nullcontext()):
        for kind, _, args, _ in rec.calls:
            if kind == "prefill":
                tokens, slot, length, _ = args
                prog, where = pair.prefill, f"admission (slot {slot})"
                rows = slice(None)
                n_adm += 1
            else:
                tokens, mask = args
                prog, where = pair.decode, "first tick"
                pos = state.lengths
                rows = live = mask.to(device=pos.device, dtype=torch.bool)
            regions = {prog.input_region: tokens.to(eng.device)}
            for op in prog.ops:
                src = regions[op.in_region]
                if op.kernel in ex._FAMILY_KERNELS:
                    kw = (dict(slot=slot, length=length) if kind == "prefill"
                          else dict(live=live))
                    got, out = family(op, src, where, **kw)
                elif op.kernel == "flash_attention":
                    got = ex._run_attention(op, regions, impl="cuda")
                    out, k, v = ex._run_attention(
                        op, regions, impl="reference", return_kv=True)
                    ex._write_prefill_cache(state.caches, op, k, v, slot,
                                            length)
                elif op.kernel == "decode_attention":
                    ck = state.caches[op.k_cache_region]
                    cv = state.caches[op.v_cache_region]
                    kv = (src, regions[op.k_region], regions[op.v_region])
                    got = ex._run_decode_attention(
                        op, *kv, ck.clone(), cv.clone(), pos, live,
                        impl="cuda")
                    out = ex._run_decode_attention(op, *kv, ck, cv, pos,
                                                   live, impl="reference")
                elif op.kernel == "moe_dispatch":
                    # plain torch on both paths: the same input gives the
                    # same bits
                    n = length if kind == "prefill" else None
                    got = ex._run_moe(op, src, regions, params, n)
                    out = ex._run_moe(op, src, regions, params, n)
                    if not torch.equal(got, out):
                        fail(f"{where} {op.name}: the dispatch is not "
                             f"deterministic on the same input")
                    n_ops["moe_dispatch"] += 1
                elif op.kernel in KERNEL_OPS:
                    got = ex._run_op(op, src, regions, params, impl="cuda")
                    out = ex._run_op(op, src, regions, params,
                                     impl="reference")
                else:
                    got = out = ex._run_op(op, src, regions, params,
                                           impl="reference")
                if op.kernel in KERNEL_OPS:
                    _held(got[rows], out[rows], f"{where} {op.name}", errs,
                          op.kernel, op.kernel in ex._FAMILY_KERNELS)
                    n_ops[op.kernel] += 1
                regions[op.out_region] = out
            if kind != "prefill":
                break
            state.lengths[slot] = length
        else:
            fail(f"{label}: no decode tick recorded to check op by op")
    print(f"{label}: every kernel op of {n_adm} admissions and the first "
          f"tick held to its plain version on the same input (bf16 "
          f"2^-7, a block's output 2^-7 of its largest magnitude, f32 "
          f"states 1e-4): ops {dict(n_ops)}; max |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)


def serve_family(label: str, arch: str):
    """Phases 5g, 5h and 5j: ``repro_torch.launch.serve --arch <arch>`` at
    full width and depth in bf16 (random weights from the seed), 8 slots,
    max_len 512, 8 prompts of 32-448 tokens, 32 new tokens each, through
    ``serve_lm``'s launch, completion and replay checks, then served
    again eagerly once the graphed engine's weights and state are freed
    (``check_eager``): granite's rows bit for bit, the recurrent
    families' within the replay's bound.  Returns (launches, stats)."""
    import gc
    import torch
    from repro_torch.launch import serve
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n, new = (int(FAMILY_ARGS[FAMILY_ARGS.index(f) + 1])
              for f in ("--requests", "--max-new"))

    def run():
        return serve.main(["--arch", arch] + FAMILY_ARGS)
    t0 = time.perf_counter()
    launches, stats, eng, rec = serve_lm(label, run, n, new, arch=arch)
    took(f"{label} served and replayed", t0)
    t0 = time.perf_counter()
    check_family_ops(label, eng, rec, arch)
    took(f"{label} per-op check", t0)
    peak = torch.cuda.max_memory_allocated()   # the served phase's alone
    if arch != MOE_ARCH:
        t0 = time.perf_counter()
        stats["legacy"] = legacy_leg(label, eng, stats, arch)
        took(f"{label} legacy leg", t0)
    pair = eng.program
    state_mb = {}
    for r in pair.decode.plan.persistent_regions():
        kind = r.name.split(".")[-1]
        state_mb[kind] = state_mb.get(kind, 0.0) + r.size_bytes / 1e6
    n_params = sum(t.numel() for t in _named_leaves(eng.params).values())
    stats.update(state_mb=state_mb, n_params=n_params, peak_gb=peak / 1e9)
    print(f"{label}: {n_params / 1e9:.3f} B parameters, persistent state "
          f"{pair.persistent_bytes / 1e6:.2f} MB (" + ", ".join(
              f"{k} {v:.2f} MB" for k, v in state_mb.items())
          + f"), peak memory allocated {stats['peak_gb']:.2f} GB",
          flush=True)
    del eng, pair
    gc.collect()
    torch.cuda.empty_cache()
    # cuBLAS runs zamba2's and rwkv6's in / out projections, so their
    # eager rows are held to the teacher-forced replay's gate; granite's
    # bit for bit (cuBLAS runs its experts' products, and keeps its
    # algorithms on the capture stream, as it does for those
    # projections).
    t0 = time.perf_counter()
    stats.update(check_eager(label, run, stats, rec, exact=arch == MOE_ARCH,
                             bound=stats["logit_bound"]))
    took(f"{label} eager serve", t0)
    return launches, stats


def serve_whisper(label: str):
    """Phase 5l: ``repro_torch.launch.serve --arch whisper-base`` at full
    width and depth in bf16 (WHISPER_ARGS: 16 requests on 8 slots, so
    every slot is re-admitted once, prompts of 4-224 tokens, 32 new
    tokens each, each request's (1500, 512) stub frames from the seed),
    through ``serve_lm``'s launch, path, completion and replay checks:
    the teacher-forced plain replay re-encodes each request's frames
    through the plain path, so a re-admitted slot that read another
    request's memory would fail it.  Then served again eagerly
    (``check_eager``): identical streams, logits rows bit for bit.
    Returns (launches, stats)."""
    import gc
    import torch
    from repro_torch.launch import serve
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n, new = (int(WHISPER_ARGS[WHISPER_ARGS.index(f) + 1])
              for f in ("--requests", "--max-new"))

    def run():
        return serve.main(WHISPER_ARGS)
    launches, stats, eng, rec = serve_lm(label, run, n, new, arch=WHISPER)
    peak = torch.cuda.max_memory_allocated()   # the served phase's alone
    stats["legacy"] = legacy_leg(label, eng, stats, WHISPER)
    slots_used = Counter(c[2][0] for c in rec.calls if c[0] == "memory")
    if sorted(slots_used.values()) != [n // SLOTS] * SLOTS:
        fail(f"{label}: admissions per slot {dict(slots_used)}, want "
             f"{n // SLOTS} on each of {SLOTS}")
    pair = eng.program
    state_mb = {}
    for r in pair.decode.plan.persistent_regions():
        kind = r.name.split(".")[-1]
        state_mb[kind] = state_mb.get(kind, 0.0) + r.size_bytes / 1e6
    n_params = sum(t.numel() for t in _named_leaves(eng.params).values())
    stats.update(state_mb=state_mb, n_params=n_params, peak_gb=peak / 1e9)
    print(f"{label}: {n_params / 1e6:.1f} M parameters, persistent state "
          f"{pair.persistent_bytes / 1e6:.2f} MB (" + ", ".join(
              f"{k} {v:.2f} MB" for k, v in state_mb.items())
          + f"), peak memory allocated {stats['peak_gb']:.2f} GB; encoder "
          f"and memory write per admission {stats['encoder_ms']:.3f} ms "
          f"mean, {stats['encoder_median_ms']:.3f} median ({n} admissions, "
          f"{dict(slots_used)} per slot)", flush=True)
    del eng, pair
    gc.collect()
    torch.cuda.empty_cache()
    stats.update(check_eager(label, run, stats, rec, exact=True))
    return launches, stats


@contextlib.contextmanager
def sdpa_plain():
    """Inside, the plain path's attention is PyTorch's fused
    ``scaled_dot_product_attention`` on the bf16 operands (the kv heads
    repeated for each group, ``kv_len`` as a mask): a second plain
    version of the legacy path that rounds as a fused bf16 attention
    does.  A version that only reorders the f32 sums rounds to the same
    bf16 values far more often than a fused kernel: on 5o it left some
    cache rows equal to the plain ones bit for bit, so a floor taken row
    by row from it is 0 there, under the kernels' own rounding."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    orig = flash_ops.flash_ref, decode_ops.decode_attention_ref

    def groups(q, k, v):
        g = q.shape[1] // k.shape[1]
        return k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)

    def flash(q, k, v, *, scale=None, causal=False, window=None,
              kv_len=None, chunk=512, return_lse=False):
        if window is not None or return_lse or (causal and kv_len is not None):
            raise NotImplementedError("sdpa_plain: window, lse, or causal "
                                      "with kv_len")
        k, v = groups(q, k, v)
        mask = (None if kv_len is None else
                torch.arange(k.shape[2], device=q.device) < kv_len)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              is_causal=causal, scale=scale)

    def decode(q, k, v, *, kv_len=None, scale=None):
        k, v = groups(q[:, :, None], k, v)
        mask = (None if kv_len is None else
                (torch.arange(k.shape[2], device=q.device)[None]
                 < kv_len[:, None])[:, None, None])
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, scale=scale)[:, :, 0]
    flash_ops.flash_ref, decode_ops.decode_attention_ref = flash, decode
    try:
        yield
    finally:
        flash_ops.flash_ref, decode_ops.decode_attention_ref = orig


def plain_floor(pairs) -> tuple[float, float, float]:
    """The logits gate of a model whose depth amplifies one-ulp
    differences past any fixed bound (a recurrent family, MoE routing,
    40 random-weight bf16 layers), measured on the same calls: ``pairs``
    holds each logits row of two plain versions that sum in other
    orders.  Returns (bound, mean, spread): ``spread`` is their largest
    difference, ``bound`` max(``LOGIT_TOL``, twice it) and ``mean`` their
    mean |diff| per row."""
    import numpy as np
    d = [np.abs(a - b) for a, b in pairs]
    spread = max(float(x.max()) for x in d)
    return (max(LOGIT_TOL, 2 * spread), float(np.mean([x.mean() for x in d])),
            spread)


def hold_rows(label: str, rows, bound: float, mean_tol: float | None,
              against: str = "the plain path"):
    """Every logits row against its reference: finite and within
    ``bound``; the token equal wherever the reference's top-2 gap exceeds
    twice the row's largest difference; the mean |diff| per row within
    ``mean_tol`` (None: not held).  ``rows``: (where, got, want) with two
    (V,) f32 rows.  Returns (worst, mean, rows, token ids compared, the
    largest row's mean)."""
    import numpy as np
    worst, means, n_ids = 0.0, [], 0
    for where, g, w in rows:
        diff = float(np.abs(g - w).max())
        worst = max(worst, diff)
        means.append(float(np.abs(g - w).mean()))
        if not np.isfinite(g).all() or diff > bound:
            fail(f"{label} {where}: logits differ from {against} by "
                 f"{diff:.3e} > {bound:.3e}")
        top2 = np.sort(w)[-2:]
        if top2[1] - top2[0] > 2 * diff:
            n_ids += 1
            if int(np.argmax(g)) != int(np.argmax(w)):
                fail(f"{label} {where}: token {int(np.argmax(g))} != "
                     f"{int(np.argmax(w))} of {against}, with a top-2 "
                     f"gap of {top2[1] - top2[0]:.3f}")
    mean = float(np.mean(means))
    if mean_tol is not None and mean > mean_tol:
        fail(f"{label}: logits differ from {against} by {mean:.4f} per "
             f"row on the mean > {mean_tol:.4f}")
    return worst, mean, len(means), n_ids, max(means)


def call_rows(calls):
    """(where, got, want) for ``hold_rows`` from per-call (got, want)
    pairs of (B, V) rows."""
    return ((f"call {t} row {i}", g[i], w[i])
            for t, (g, w) in enumerate(calls) for i in range(len(g)))


def hold_cache(label: str, got: dict, plain: dict, alt: dict) -> dict:
    """5o's final legacy cache against the plain path's, leaf by leaf and
    layer by layer: each element within 2^-7 (1 + |x|) plus twice the
    largest difference between the two plain versions' caches (``alt``:
    ``sdpa_plain``) at the same slot and row of that layer, over its
    heads and head dim.  A K/V row is projected
    from its token's residual stream, which the random-weight model
    moves by more than an ulp with depth, on either path alike: the
    floor is measured row by row, so a fault in one row or one slot is
    held to that row's own spread, not the layer's largest.  ``pos``
    exactly.  Prints, by layer, the two plain versions' largest
    difference and the worst |err| / limit; returns them by leaf."""
    import torch
    if not torch.equal(got["pos"], plain["pos"]):
        fail(f"{label}: cache pos {got['pos']} != {plain['pos']}")
    report, bad = {}, []
    for k in ("k", "v", "cross_k", "cross_v"):
        worst, rule, spreads, ratios = 0.0, 0.0, [], []
        for layer, (g, p, a) in enumerate(zip(got[k], plain[k], alt[k])):
            g, p, a = g.float(), p.float(), a.float()   # (B, KV, rows, hd)
            spread = (p - a).abs().amax(dim=(1, 3), keepdim=True)
            err = (g - p).abs()
            ratio = (err / (BF16_TOL * (1 + p.abs()) + 2 * spread)).max()
            spreads.append(spread.max().item())
            ratios.append(ratio.item())
            if not bool(torch.isfinite(g).all()) or ratios[-1] > 1:
                bad.append(f"{k} layer {layer} ({ratios[-1]:.3f})")
            worst = max(worst, err.max().item())
            rule = max(rule, (err / (1 + p.abs())).max().item())
        report[k] = {"spread": spreads, "ratio": ratios}
        print(f"  cache {k} {tuple(got[k].shape)}: max |err| {worst:.3e}, "
              f"max |err| / (1 + |x|) {rule:.3e} (2^-7 = {BF16_TOL:.3e}); "
              f"by layer, the plain versions' largest row spread "
              f"{[float(f'{x:.3g}') for x in spreads]} and the worst "
              f"|err| / (2^-7 (1 + |x|) + 2 x that row's spread) "
              f"{[float(f'{x:.3g}') for x in ratios]}", flush=True)
    if bad:
        fail(f"{label}: cache leaves differ from the plain path past "
             f"2^-7 (1 + |x|) + 2 x the row's plain spread: "
             f"{', '.join(bad)}")
    return report


def serve_vlm(device) -> tuple[dict, dict]:
    """Phase 5o: llama-3.2-vision-11b at full width and depth in bf16
    (about 10.1 B parameters, 20.2 GB), weights drawn from the seed; the
    8 cross gates, zeros at init (tanh(0) = 0 would shut the cross path),
    are drawn nonzero, |g| in [0.5, 1.5) with random signs, from the same
    seed.  It has no Program lowering, so it runs the legacy path:

    a. the generate path: ``forward(vision_embeds=(8, 1601, 4096) stub,
       return_cache=True, cache_len=512)`` on 8 prompts of 128 tokens,
       then VLM_STEPS greedy ``decode_step``s: exactly 40 self + 8 cross
       flash launches in the forward and 40 + 8 decode launches a step,
       no matmul launch (the projections are plain ``@``); the same calls
       replayed through the plain path (``impl="reference"``) and a
       second plain version whose attention is the library's fused bf16
       one (``sdpa_plain``), the logits held by ``plain_floor`` /
       ``hold_rows``, the final cache leaves by ``hold_cache``; the
       forward again with the
       gates zeroed must move the last rows' logits by more than the
       bound (the cross path reaches the logits);
    b. ``ServingEngine`` with its default ``use_program=True`` falls back
       (a RuntimeWarning, ``fallback_reason`` naming the reference's
       blockers) and serves VLM_REQUESTS requests of 4-32 prompt tokens
       and VLM_NEW new tokens on 8 slots, max_len 512, no vision input
       (as in the reference; the loop's cross memory stays zero): exactly
       48 decode launches a ``decode_step`` (a teacher-forced admission
       step or a tick), no flash; tok/s and the step ms; every call
       replayed teacher-forced through a plain engine (the same resets,
       masks and tokens) under (a)'s gate.

    Returns (launches, stats)."""
    import gc
    import warnings
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_params, param_defs, transformer
    from repro_torch.serving import Request, ServingEngine
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    label = f"5o {VLM_ARCH}"
    cfg = get_config(VLM_ARCH)
    G = cfg.n_layers // cfg.cross_attn_every
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(param_defs(cfg), gen, device)
    mag = torch.rand((G,), generator=gen, device=device) + 0.5
    sign = torch.randint(0, 2, (G,), generator=gen, device=device) * 2 - 1
    gates = (mag * sign).to(cfg.tdtype)
    params["cross_blocks"]["gate"] = gates
    n_params = sum(t.numel() for t in _named_leaves(params).values())
    vis = torch.randn((SLOTS, cfg.n_vision_tokens, cfg.d_model),
                      generator=gen, device=device).to(cfg.tdtype)
    toks = torch.randint(0, cfg.vocab, (SLOTS, VLM_PROMPT), generator=gen,
                         device=device).to(torch.int32)
    print(f"{label}: {n_params / 1e9:.3f} B parameters "
          f"({2 * n_params / 1e9:.2f} GB bf16; analytic "
          f"{cfg.n_params() / 1e9:.3f} B), "
          f"cross gates {[round(float(g), 3) for g in gates]}", flush=True)
    counters = lm_counters()

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items() if fn.launches}
    per_fwd = {"flash_attention": cfg.n_layers + G}
    per_step = {"decode_attention": cfg.n_layers + G}

    def generate(impl, fed=None):
        """forward + VLM_STEPS decode steps (greedy, or fed ``fed``):
        (per call (8, V) f32 rows, the fed tokens, the final cache, ms)."""
        ms = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = transformer.forward(params, toks, cfg, vision_embeds=vis,
                                  impl=impl, return_cache=True,
                                  cache_len=LM_MAX_LEN)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        rows = [out["logits"][:, -1].float().cpu().numpy()]
        cache = out["cache"]
        del out
        fed = fed or []
        for t in range(VLM_STEPS):
            if len(fed) <= t:
                fed.append(torch.from_numpy(rows[-1].argmax(-1).astype(
                    np.int32)).to(device))
            if impl == "auto" and read() != (per_fwd if t == 0 else {}):
                fail(f"{label}: launches {read()} before step {t}, want "
                     f"{per_fwd if t == 0 else {}}")
            reset()
            t0 = time.perf_counter()
            logits, cache = transformer.decode_step(params, cache, fed[t],
                                                    cfg, impl=impl)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            rows.append(logits.float().cpu().numpy())
            if impl == "auto":
                if read() != per_step:
                    fail(f"{label}: step {t} launches {read()}, want "
                         f"{per_step}")
                reset()
        return rows, fed, cache, ms

    with torch.no_grad():
        reset()
        reset_flash_paths()
        got, fed, cache, ms = generate("auto")
        check_flash_paths(label, per_fwd["flash_attention"], 0)
        # Where an eager step's time goes: one more step (the cache is
        # not written: the step is functional) under the profiler.
        step_prof = profile_train(
            f"{label} decode step",
            lambda: transformer.decode_step(params, cache, fed[-1], cfg),
            statistics.median(ms[1:]))
        launches = {"flash_attention": per_fwd["flash_attention"],
                    "decode_attention": VLM_STEPS
                    * per_step["decode_attention"]}
        plain, _, pcache, _ = generate("reference", fed)
        with sdpa_plain():
            alt, _, acache, _ = generate("reference", fed)
        bound, plain_mean, spread = plain_floor(zip(
            (r for rows in plain for r in rows),
            (r for rows in alt for r in rows)))
        mean_tol = 2 * plain_mean
        print(f"{label}: bound {bound:.3e} = max({LOGIT_TOL}, 2 x "
              f"{spread:.3e}, the two plain versions' largest difference), "
              f"mean limit {mean_tol:.4f} (twice theirs)")
        worst, mean, n_rows, n_ids, _ = hold_rows(
            f"{label} generate", call_rows(zip(got, plain)), bound, mean_tol)
        print(f"{label} generate: {n_rows} logits rows within "
              f"{worst:.3e} of the plain path (bound {bound:.3e}); mean "
              f"|diff| per row {mean:.4f} (limit {mean_tol:.4f}); {n_ids} "
              f"token ids compared, all equal", flush=True)
        cache_report = hold_cache(label, cache, pcache, acache)
        del cache, pcache, acache
        params["cross_blocks"]["gate"] = torch.zeros_like(gates)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shut = transformer.forward(params, toks, cfg, vision_embeds=vis)
        torch.cuda.synchronize()
        again_ms = 1e3 * (time.perf_counter() - t0)
        params["cross_blocks"]["gate"] = gates
        moved = float(np.abs(shut["logits"][:, -1].float().cpu().numpy()
                             - got[0]).max())
        del shut
        if moved <= bound:
            fail(f"{label}: zeroing the cross gates moves the logits by "
                 f"{moved:.3e}, not past the bound {bound:.3e}")
    print(f"{label} generate: forward of {SLOTS} x {VLM_PROMPT} tokens over "
          f"{cfg.n_vision_tokens} vision rows {ms[0]:.2f} ms (the first; "
          f"again, gates zeroed, {again_ms:.2f} ms), decode step "
          f"{statistics.median(ms[1:]):.2f} ms median / "
          f"{statistics.mean(ms[1:]):.2f} mean (eager); launches "
          f"{per_fwd} a forward, {per_step} a step; the gates zeroed move "
          f"the logits by {moved:.3e} (> {bound:.3e})", flush=True)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = ServingEngine(cfg, params, slots=SLOTS, max_len=LM_MAX_LEN,
                            device=device)
    blockers = ("blocked by: family=vlm (not a decoder-only transformer "
                "graph), gated cross-attention (vision bridge), "
                "vision-encoder inputs")
    if (eng.on_program_path or blockers not in (eng.fallback_reason or "")
            or not any(issubclass(w.category, RuntimeWarning)
                       for w in caught)):
        fail(f"{label}: the engine did not fall back with the reference's "
             f"blockers: {eng.fallback_reason!r}")
    calls = []
    orig = {n: getattr(eng, n) for n in ("_reset_slots", "_step_masked",
                                         "_legacy_decode")}

    def reset_slots(slots):
        calls.append(("reset", list(slots)))
        return orig["_reset_slots"](slots)

    def step_masked(t, mask):
        calls.append(("mask", mask.copy()))
        return orig["_step_masked"](t, mask)

    def decode(t):
        live = (calls[-1][1].nonzero()[0].tolist()
                if calls and calls[-1][0] == "mask" else sorted(eng.live))
        t0 = time.perf_counter()
        out = orig["_legacy_decode"](t)
        torch.cuda.synchronize()
        calls.append(("decode", 1e3 * (time.perf_counter() - t0), t.copy(),
                      {i: out[0][i].float().cpu().numpy() for i in live}))
        return out
    eng._reset_slots, eng._step_masked = reset_slots, step_masked
    eng._legacy_decode = decode
    prompts = serve.make_prompts(cfg.vocab, VLM_REQUESTS, *VLM_PROMPT_LEN,
                                 SEED)
    reset()
    reset_flash_paths()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=VLM_NEW))
    done = eng.run_until_drained()
    seconds = time.perf_counter() - t0
    steps = [c for c in calls if c[0] == "decode"]
    n_tok = sum(len(r.out_tokens) for r in done)
    if len(done) != VLM_REQUESTS or n_tok != VLM_REQUESTS * VLM_NEW:
        fail(f"{label}: served {len(done)} requests, {n_tok} tokens")
    want = {"decode_attention": len(steps) * per_step["decode_attention"]}
    if read() != want:
        fail(f"{label} engine: launches {read()}, want {want}")
    launches["decode_attention"] += want["decode_attention"]
    step_ms = [c[1] for c in steps]
    with torch.no_grad():
        ref = ServingEngine(cfg, params, slots=SLOTS, max_len=LM_MAX_LEN,
                            device=device, impl="reference",
                            use_program=False)
        e_got, e_plain, mask = [], [], None
        for c in calls:
            if c[0] == "reset":
                ref._reset_slots(c[1])
            elif c[0] == "mask":
                mask = c[1]
            else:
                if mask is not None:
                    logits = ref._step_masked(c[2], mask)
                else:
                    logits, ref.cache = ref._legacy_decode(c[2])
                mask = None
                rows = logits.float().cpu().numpy()
                e_got.append(np.stack(list(c[3].values())))
                e_plain.append(rows[list(c[3])])
        del ref
    live_rows = [(g, p) for g, p in zip(e_got, e_plain) if len(g)]
    worst_e, mean_e, n_rows, n_ids, _ = hold_rows(
        f"{label} engine replay", call_rows(live_rows), bound, mean_tol)
    print(f"{label} engine replay: {n_rows} logits rows within "
          f"{worst_e:.3e} of the plain path (bound {bound:.3e}); mean "
          f"|diff| per row {mean_e:.4f} (limit {mean_tol:.4f}); {n_ids} "
          f"token ids compared, all equal", flush=True)
    stats = {"tok_s": n_tok / seconds, "step_ms": statistics.median(step_ms),
             "step_mean_ms": statistics.mean(step_ms),
             "forward_ms": again_ms, "gen_step_ms": statistics.median(ms[1:]),
             "worst": worst, "bound": bound, "mean": mean,
             "step_profile": step_prof, "cache": cache_report,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{label} engine: fell back to the legacy loop; {n_tok} tokens in "
          f"{seconds:.3f} s ({stats['tok_s']:.1f} tok/s); {len(steps)} "
          f"decode_step calls (admission steps and ticks), "
          f"{stats['step_ms']:.2f} ms median, {stats['step_mean_ms']:.2f} "
          f"mean; launches {want}; logits rows within {worst_e:.3e} of the "
          f"teacher-forced plain replay (bound {bound:.3e}), mean "
          f"{mean_e:.4f}; peak memory "
          f"{stats['peak_gb']:.2f} GB; 5o took "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    del eng, params, vis
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


def legacy_leg(label: str, eng, stats, arch: str) -> dict:
    """The legacy leg of 5b, 5g, 5h and 5l, on the phase's parameters:
    its first SLOTS prompts, cut to the shortest of them (whisper's with
    their stub frames), admitted through the phase's Program pair
    (eagerly, on a fresh state) and decoded LEGACY_STEPS ticks on its
    greedy tokens; then the same batch through the legacy ``forward
    (return_cache=True, cache_len=max_len)`` and LEGACY_STEPS
    ``decode_step``s fed the pair's tokens, with the counters set to 0
    just before and read just after.  The legacy path launches what the
    pair's listing launches a layer: a flash kernel per attention (and
    per cross) op and a scan per recurrent block in the forward (one
    batched launch where the pair makes one per admission), the
    encoder's flash per layer, a decode kernel per attention and cross
    op and a scan per mamba block each step; never the matmul kernel
    (its projections are plain ``@``, as in the reference) nor wkv6 in a
    step (plain, as in the reference).  Every logits row is held to the
    pair's under the phase's gate (``stats["logit_bound"]``, the token
    rule, and for the recurrent families the mean |logit diff| within
    ``FAMILY_MEAN_TOL``).  Returns the launches and times."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    from repro_torch.runtime import executor
    cfg, pair, params, dev = eng.cfg, eng.program, eng.params, eng.device
    prompts = stats["prompts"][:SLOTS]
    P = min(len(p) for p in prompts)
    toks = np.stack([p[:P] for p in prompts]).astype(np.int32)
    frames = serve.make_frames(cfg, len(stats["prompts"]), SEED)
    state = executor.init_program_state(pair, dev)
    with torch.no_grad():
        rows = []
        for s in range(SLOTS):
            if frames is not None:
                write_memory(eng, state, s, torch.from_numpy(frames[s]),
                             "auto")
            padded = torch.zeros((1, eng.max_len), dtype=torch.int32)
            padded[0, :P] = torch.from_numpy(toks[s])
            out = executor.run_prefill(pair.prefill, params, padded.to(dev),
                                       state, s, P, 0)
            rows.append(out[0, P - 1].float().cpu().numpy())
        want, fed = [np.stack(rows)], []
        live = torch.ones((SLOTS,), dtype=torch.bool, device=dev)
        for _ in range(LEGACY_STEPS):
            fed.append(torch.from_numpy(want[-1].argmax(-1).astype(np.int32)))
            want.append(executor.run_decode(pair.decode, params,
                                            fed[-1].to(dev), state, live)
                        .float().cpu().numpy())
    del state
    pre, dec = (Counter(op.kernel for op in prog.ops
                        if op.kernel in KERNEL_OPS)
                for prog in (pair.prefill, pair.decode))
    want_fwd = {"flash_attention": pre["flash_attention"]
                + pre["cross_attention"] + cfg.n_encoder_layers,
                "mamba2_scan": pre["ssm_scan"], "wkv6": pre["wkv"]}
    want_step = {"decode_attention": dec["decode_attention"]
                 + dec["cross_attention"], "mamba2_scan": dec["ssm_scan"]}
    counters = lm_counters()
    api = get_model(cfg)
    kw = {} if frames is None else {"encoder_frames": torch.from_numpy(
        np.stack(frames[:SLOTS])).to(dev, cfg.tdtype)}
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = api.forward(params, torch.from_numpy(toks).to(dev), cfg,
                          return_cache=True, cache_len=eng.max_len, **kw)
        torch.cuda.synchronize()
        fwd_ms = 1e3 * (time.perf_counter() - t0)
        fwd = {k: fn.launches for k, fn in counters.items()}
        got = [out["logits"][:, -1].float().cpu().numpy()]
        cache = out["cache"]
        del out
        step_ms = []
        for nxt in fed:
            t0 = time.perf_counter()
            logits, cache = api.decode_step(params, cache, nxt.to(dev), cfg)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            got.append(logits.float().cpu().numpy())
    del cache
    launches = {k: fn.launches for k, fn in counters.items()}
    want_all = {k: want_fwd.get(k, 0) + LEGACY_STEPS * want_step.get(k, 0)
                for k in counters}
    if {k: v for k, v in fwd.items() if v} != {
            k: v for k, v in want_fwd.items() if v} or launches != want_all:
        fail(f"{label} legacy: launches {fwd} in the forward, {launches} "
             f"in all; want {want_fwd} and {want_all}")
    bound, mean_tol = stats["logit_bound"], FAMILY_MEAN_TOL.get(arch)
    worst, mean, _, n_ids, _ = hold_rows(
        f"{label} legacy", call_rows(zip(got, want)), bound, mean_tol,
        against="the pair")
    print(f"{label} legacy: forward of {SLOTS} x {P} tokens "
          f"{fwd_ms:.2f} ms, {LEGACY_STEPS} decode steps "
          f"{statistics.median(step_ms):.2f} ms median (eager); launches "
          f"{ {k: v for k, v in launches.items() if v} } as the pair's "
          f"listing per layer; {len(got) * SLOTS} logits rows within "
          f"{worst:.3e} of the pair's (bound {bound:.3e}), mean "
          f"{mean:.4f}" + (f" (limit {mean_tol})" if mean_tol else "")
          + f", {n_ids} tokens equal", flush=True)
    return {"launches": launches, "forward_ms": fwd_ms,
            "step_ms": statistics.median(step_ms), "worst": worst,
            "mean": mean}


# Phase 5m: speculative decode on the observability plane.  The flags
# after LM_ARGS of each engine; the self-draft engine also samples one
# tick in SPEC_SAMPLE op by op and prints a dashboard every SPEC_DASH
# ticks.  A speculative tick's sampled walk is its first draft round's
# decode Program: each op once untimed, then OpTimingSampler.REPEATS
# timed calls, all eager.
SPEC_RUNS = {"self-draft": ["--spec-decode", "4"],
             "disagreeing draft": ["--spec-decode", "4", "--draft", LM_ARCH],
             "chunked": ["--chunk-size", "128", "--spec-decode", "3"]}
SPEC_SAMPLE, SPEC_DASH = 8, 16


class SpecRecorder(Recorder):
    """``Recorder`` for phase 5m: each call also keeps the state it ran
    on (``states``: the target's or the draft's); a verify (a chunk call
    whose length is pinned past the token buffer) keeps rows ``[start,
    stop)`` of each slot; each speculative tick of the engine is timed
    to a device synchronise (``spec_ticks``)."""

    def __init__(self):
        super().__init__()
        self.states, self.spec_ticks = [], []

    def _record(self, kind, dt, args, out):
        import numpy as np
        if kind == "chunk" and int(np.asarray(args[6])[0]) > args[1].shape[1]:
            slots, starts, stops = (np.array(x) for x in args[3:6])
            self.calls.append(("verify", dt, (slots, starts, stops), {
                i: out[i, a:b].clone()
                for i, (a, b) in enumerate(zip(starts, stops))}))
        else:
            super()._record(kind, dt, args, out)
        self.states.append(args[2])

    def __enter__(self):
        import torch
        super().__enter__()
        self.orig_tick = tick = self.engine_cls._spec_tick
        rec = self

        def spec_tick(eng, *args):
            t0 = time.perf_counter()
            out = tick(eng, *args)
            torch.cuda.synchronize()
            rec.spec_ticks.append(time.perf_counter() - t0)
            return out
        self.engine_cls._spec_tick = spec_tick
        return self

    def __exit__(self, *exc):
        self.engine_cls._spec_tick = self.orig_tick
        super().__exit__(*exc)

    def tagged(self, eng) -> list:
        """(kind, role, dt, args, rows) of every Program run, ``role``
        "target" or "draft" by the state it ran on."""
        return [(c[0], "draft" if s is eng._draft_state else "target",
                 c[1], c[2], c[3]) for c, s in zip(self.calls, self.states)
                if c[0] in ("prefill", "chunk", "decode", "verify")]

    def median_ms(self, eng, kind: str, role: str, width=None,
                  skip: int = 0) -> tuple:
        """(median ms, calls) of the ``role``'s ``kind`` calls (a
        verify's of ``width`` B), past the first ``skip`` of them."""
        times = [dt for k, r, dt, args, _ in self.tagged(eng)
                 if (k, r) == (kind, role)
                 and (width is None or len(args[0]) == width)][skip:]
        return (1e3 * statistics.median(times) if times else None,
                len(times))


def state_hash(state) -> str:
    """sha256 over every persistent buffer's bytes and the lengths."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for rid in sorted(state.caches):
        h.update(state.caches[rid].contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    h.update(state.lengths.cpu().numpy().tobytes())
    return h.hexdigest()


def spec_groups(events) -> list:
    """(uid, slot, accepted, tokens emitted before, tokens kept) of each
    ``spec`` flight event, in order: the tokens the engine emitted off
    that slot's verify rows."""
    groups, emitted, cur = [], Counter(), None
    for e in events:
        if e["ev"] == "spec":
            cur = [e["uid"], e["slot"], e["accepted"], emitted[e["uid"]], []]
            groups.append(cur)
        elif e["ev"] == "tick":
            cur = None
        elif e["ev"] in ("first_token", "token"):
            if cur is not None and e["uid"] == cur[0]:
                cur[4].append(e["token"])
            emitted[e["uid"]] += 1
    return groups


def spec_launch_check(label, eng, rec, launches, bt_launches) -> dict:
    """Exact launches of a speculative run, computed from its recorded
    calls and cross-checked against the engine's counters: every
    admission prefills target and draft (a chunked one: the target in
    chunk calls), every tick runs max_k draft decode rounds and one
    verify chunk call; a sampled tick (one in SPEC_SAMPLE of the ticks
    with a draft round) walks the draft's decode Program eagerly, each
    op 1 + ``OpTimingSampler.REPEATS`` times.  Decode calls and walks on
    skinny, prefills, chunks and verifies on wgmma, every flash launch
    on mma."""
    from repro_torch.runtime.executor import OpTimingSampler
    sampled_calls = 1 + OpTimingSampler.REPEATS
    calls = rec.tagged(eng)
    n = Counter((k, r) for k, r, *_ in calls)
    verify = [args for k, _, _, args, _ in calls if k == "verify"]
    samples = eng._op_sampler.n_samples if eng._op_sampler else 0
    prefill_rows = sum(len(args[0]) if k == "chunk" else 1
                       for k, r, _, args, _ in calls
                       if r == "target" and k in ("prefill", "chunk"))
    checks = {
        "draft prefills = admissions": (n[("prefill", "draft")],
                                        eng.n_prefills),
        "verify calls = ticks": (len(verify), eng.n_decode_ticks),
        "target decode calls (wrapped slots)": (n[("decode", "target")], 0),
        "draft rounds = sum of max_k": (
            n[("decode", "draft")],
            sum(int((b - a).max()) - 1 for _, a, b in verify)),
        "proposed = sum of k_s": (
            sum(int((b - a - 1).sum()) for _, a, b in verify),
            eng.n_spec_proposed),
        "target prefill rows = admissions or chunk rows": (
            prefill_rows, (eng.n_prefill_chunks if eng.chunk_size
                           else eng.n_prefills)),
        "sampled walks": (samples, (
            sum(int((b - a).max()) > 1 for _, a, b in verify)
            // SPEC_SAMPLE if eng._op_sampler else 0))}
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad:
        fail(f"{label}: recorded calls disagree with the engine: {bad}")
    pre, dec = PAIR_OPS[LM_ARCH]
    passes = (n[("prefill", "target")] + n[("prefill", "draft")]
              + n[("chunk", "target")] + len(verify))
    decodes = (n[("decode", "draft")] + n[("decode", "target")]
               + sampled_calls * samples)
    want = {k: 0 for k in launches}
    want.update(flash_attention=passes * pre["flash_attention"],
                decode_attention=decodes * dec["decode_attention"],
                matmul=passes * pre["matmul"] + decodes * dec["matmul"])
    print(f"{label}: {n[('prefill', 'target')]} + {n[('prefill', 'draft')]}"
          f" prefills (target + draft), {n[('chunk', 'target')]} chunk "
          f"calls, {len(verify)} verify calls, {n[('decode', 'draft')]} "
          f"draft rounds, {samples} sampled walks; launches {launches}, "
          f"want {want}", flush=True)
    if launches != want:
        fail(f"{label}: launch counts {launches} != {want}")
    paths = Counter()
    for n_calls, prog, M in ((passes, eng.program.prefill, eng.max_len),
                             (decodes, eng.program.decode, eng.slots)):
        for path, k in matmul_paths(eng.cfg, prog, M).items():
            paths[path] += n_calls * k
    check_matmul_paths(label, paths["skinny"], paths["wgmma"],
                       paths["simt"])
    check_flash_paths(label, want["flash_attention"], 0)
    n_tied = sum(op.transpose_w for op in eng.program.decode.ops)
    if bt_launches != n_tied * (passes + decodes):
        fail(f"{label}: {bt_launches} matmul launches read B transposed, "
             f"want {n_tied * (passes + decodes)}")
    return {"passes": passes, "decodes": decodes, "verify": len(verify),
            "rounds": n[("decode", "draft")], "samples": samples}


def spec_oracle(label, eng, rec, res, events, base_streams) -> dict:
    """Point 6's oracle on the card: (a) every token a verify emitted is
    the argmax of the verify row that emitted it, exactly; every such
    row within ``LOGIT_TOL`` of the plain path's row at the same
    position (one plain prefill of the request's prompt and stream,
    teacher-forced) and its token the plain one wherever the plain
    top-2 gap exceeds twice the row's difference; (b) at each request's
    first divergence from 5b's plain greedy stream, the plain row's
    top-2 gap within ``LOGIT_TOL``: a near-tie, which two bf16 paths
    (the verify's flash and wgmma, decode's kernel and skinny) may break
    either way."""
    import numpy as np
    import torch
    ex, pair, dev = rec.ex, eng.program, eng.device
    done = {r.uid: r for r in res["done"]}
    prompts = res["prompts"]
    pstate = ex.init_program_state(pair, dev)
    plain = {}
    for uid, r in done.items():
        seq = np.concatenate([prompts[uid], r.out_tokens[:-1]])
        tok = torch.zeros((1, eng.max_len), dtype=torch.int32)
        tok[0, :len(seq)] = torch.from_numpy(seq.astype(np.int32))
        out = ex.run_prefill(pair.prefill, eng.params, tok.to(dev), pstate,
                             0, len(seq), 0, impl="reference")
        plain[uid] = out[0, len(prompts[uid]) - 1:len(seq)].float().cpu()
    rows = [(args[0][i], got[i]) for k, _, _, args, got in rec.tagged(eng)
            if k == "verify" for i in range(len(args[0]))]
    groups = spec_groups(events)
    if len(rows) != len(groups):
        fail(f"{label}: {len(rows)} verify rows, {len(groups)} spec events")
    worst, n_rows, n_ids = 0.0, 0, 0
    for (slot, got), (uid, gslot, a, before, kept) in zip(rows, groups):
        if slot != gslot or len(kept) > a + 1:
            fail(f"{label}: verify slot {slot} against spec event {gslot}")
        for j, token in enumerate(kept):
            g = got[j].float().cpu()
            if int(g.argmax()) != token:
                fail(f"{label}: uid {uid} emitted {token}, its verify row's "
                     f"argmax is {int(g.argmax())}")
            w = plain[uid][before + j]
            diff = float((g - w).abs().max())
            worst, n_rows = max(worst, diff), n_rows + 1
            if not torch.isfinite(g).all() or diff > LOGIT_TOL:
                fail(f"{label}: verify row differs from the plain path by "
                     f"{diff:.3e} > {LOGIT_TOL}")
            top2 = w.topk(2).values
            if float(top2[0] - top2[1]) > 2 * diff:
                n_ids += 1
                if token != int(w.argmax()):
                    fail(f"{label}: token {token} != plain "
                         f"{int(w.argmax())}, top-2 gap "
                         f"{float(top2[0] - top2[1]):.3f}")
    diverged, ties = 0, []
    for uid, r in done.items():
        base = base_streams[uid]
        j = next((i for i, (x, y) in enumerate(zip(r.out_tokens, base))
                  if x != y), None)
        if j is None:
            continue
        diverged += 1
        top2 = plain[uid][j].topk(2).values
        ties.append(round(float(top2[0] - top2[1]), 4))
        if ties[-1] > LOGIT_TOL:
            fail(f"{label}: uid {uid} leaves 5b's stream at token {j} with "
                 f"a plain top-2 gap of {ties[-1]:.3f} > {LOGIT_TOL}")
    print(f"{label}: {n_rows} verify rows emitted their tokens (argmax, "
          f"exact), within {worst:.3e} of the plain path (bound "
          f"{LOGIT_TOL}); {n_ids} token ids compared, all equal; "
          f"{diverged} of {len(done)} streams leave 5b's plain greedy "
          f"stream, each at a near-tie (plain top-2 gaps {ties})",
          flush=True)
    return {"verify_rows": n_rows, "worst": worst, "diverged": diverged}


def spec_against_eager(label, eng, rec, erec, eres, res) -> dict:
    """The graphed speculative run against the same requests served
    under ``executor.disable_graphs()``: identical streams, the same
    calls in the same order, every recorded verify, draft and prefill
    row bitwise equal.  Returns the graphed and eager medians of a spec
    tick, a draft round and a verify call by width B."""
    import torch
    if ([r.out_tokens for r in eres["done"]]
            != [r.out_tokens for r in res["done"]]):
        fail(f"{label}: the graphed and eager speculative streams differ")
    eeng = eres["engine"]
    got, want = rec.tagged(eng), erec.tagged(eeng)
    if [(k, r, sorted(g)) for k, r, _, _, g in got] != [
            (k, r, sorted(g)) for k, r, _, _, g in want]:
        fail(f"{label}: graphed and eager serving made other calls")
    n_rows = 0
    for (k, r, _, _, g), (_, _, _, _, e) in zip(got, want):
        for i in g:
            n_rows += 1
            if not torch.equal(g[i], e[i]):
                diff = (g[i].float() - e[i].float()).abs().max().item()
                fail(f"{label}: graphed {r} {k} rows differ from the eager "
                     f"ones by {diff:.3e}")
    # A graphed shape's first call runs eagerly and its second captures:
    # the graphed medians are over the replays after them.
    out = {}
    for side, rr, ee, skip in (("graphed", rec, eng, 2),
                               ("eager", erec, eeng, 0)):
        out[f"{side}_tick"] = 1e3 * statistics.median(rr.spec_ticks)
        out[f"{side}_round"] = rr.median_ms(ee, "decode", "draft",
                                            skip=skip)[0]
        out[f"{side}_verify"] = {
            B: rr.median_ms(ee, "verify", "target", B, skip)
            for B in sorted({len(a[0]) for k, _, _, a, _ in rr.tagged(ee)
                             if k == "verify"})}

    def ms(x):
        return "-" if x is None else f"{x:.3f}"
    print(f"{label}: graphed against eager (disable_graphs) serving: "
          f"streams identical, {n_rows} verify / draft / prefill rows "
          f"bitwise equal; median ms graphed (replays) / eager: spec tick "
          f"{out['graphed_tick']:.3f} / {out['eager_tick']:.3f} (every "
          f"tick), draft round {ms(out['graphed_round'])} / "
          f"{ms(out['eager_round'])}, verify by width B: " + ", ".join(
              f"B={B} {ms(g)} ({n} replays) / "
              f"{ms(out['eager_verify'][B][0])}"
              for B, (g, n) in out["graphed_verify"].items()), flush=True)
    return out


def check_plane(label, eng, res, metrics: str, flight: str) -> list:
    """The artifacts of a run: the JSON snapshot's counters equal the
    engine's ``n_*``, the ``.prom`` text holds every counter, and the
    flight file replays every request's stream exactly.  Returns the
    flight events."""
    from repro_torch.obs import read_events, replay_summary
    counters = json.loads(Path(metrics).read_text())["counters"]
    for key in ("prefills", "prefill_recomputes", "decode_ticks",
                "prefill_chunks", "starved_ticks", "spec_proposed",
                "spec_accepted", "spec_rollbacks", "shared_pages",
                "cow_forks"):
        if counters[f"serving_{key}_total"] != getattr(eng, f"n_{key}"):
            fail(f"{label}: snapshot serving_{key}_total "
                 f"{counters[f'serving_{key}_total']} != n_{key}")
    prom = Path(metrics + ".prom").read_text().splitlines()
    missing = [k for k, v in counters.items()
               if not any(line.startswith(f"{k} ") for line in prom)]
    if missing:
        fail(f"{label}: the .prom text lacks {missing}")
    events = read_events(flight)
    summ = replay_summary(events)
    for r in res["done"]:
        if summ["requests"][r.uid]["tokens"] != r.out_tokens:
            fail(f"{label}: the flight record replays uid {r.uid} otherwise")
    print(f"{label}: snapshot counters equal the engine's n_*, "
          f"{len(counters)} counters in the .prom text, the flight record "
          f"({len(events)} events) replays all {len(res['done'])} streams",
          flush=True)
    return events


def profile_sampled_walk(label, eng) -> dict:
    """One sampled walk (the draft's decode Program over all slots, on a
    copy of the draft's state) under ``torch.profiler``, each op's call
    inside a ``record_function`` range named by its kind.  Prints, per
    kind, the walk's measured op time beside the range's host time and
    the host ops that make it up, and the device kernels' time over the
    whole walk.  A diagnostic: a profiler that does not start is
    printed, not failed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.runtime import executor
    prog, params, state = (eng._draft_pair.decode, eng._draft_params,
                           eng._draft_state)
    toks = torch.zeros((eng.slots,), dtype=torch.int32, device=eng.device)
    mask = torch.ones((eng.slots,), dtype=torch.bool, device=eng.device)
    walk = executor._run_decode_op

    def ranged(op, *args, **kw):
        with record_function(f"op:{op.kernel}"):
            return walk(op, *args, **kw)
    executor._run_decode_op = ranged
    try:
        executor.trace_program(prog, params, toks, state=state, mask=mask,
                               repeats=executor.OpTimingSampler.REPEATS)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trace = executor.trace_program(
                prog, params, toks, state=state, mask=mask,
                repeats=executor.OpTimingSampler.REPEATS)
        events = prof.events()
    except RuntimeError as e:
        print(f"{label}: profiler did not run: {e}", flush=True)
        return {}
    finally:
        executor._run_decode_op = walk
    measured = {}
    for r in trace.records:
        measured.setdefault(r.kind, []).append(1e6 * r.measured_time_s)
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)

    def kernels(e) -> list:
        """The device kernels ``e`` and its descendants launched (not
        the ranges' own spans on the device timeline)."""
        return ([k for k in e.kernels if not k.name.startswith("op:")]
                + [k for c in e.cpu_children for k in kernels(c)])
    out = {}
    for kind in ("decode_attention", "matmul"):
        name = f"op:{kind}"
        ranges = [e for e in events
                  if e.name == name and e.device_type == cpu]
        if not ranges:
            continue
        host, stack = Counter(), [c for e in ranges for c in e.cpu_children]
        while stack:
            e = stack.pop()
            host[e.name] += e.self_cpu_time_total
            stack += e.cpu_children
        n = len(ranges)
        top = [(k, v / n) for k, v in host.most_common(8)]
        out[kind] = {
            "measured_us": statistics.median(measured[kind]),
            "range_host_us": sum(e.cpu_time_total for e in ranges) / n,
            "kernel_us": sum(k.duration for e in ranges
                             for k in kernels(e)) / n,
            "kernels": sum(len(kernels(e)) for e in ranges) / n,
            "device_span_us": sum(e.device_time_total for e in events
                                  if e.name == name
                                  and e.device_type == cuda) / n,
            "host_ops": sum(len(e.cpu_children) for e in ranges) / n,
            "top_host_us": top}
        o = out[kind]
        print(f"{label} profile, {kind} ({n} calls): measured "
              f"{o['measured_us']:.1f} us median under the profiler; the "
              f"call's host range {o['range_host_us']:.1f} us, "
              f"{o['host_ops']:.1f} top-level host ops; its kernels "
              f"{o['kernels']:.1f}, {o['kernel_us']:.1f} us of device "
              f"time, spread over {o['device_span_us']:.1f} us of the "
              f"device timeline; self host us a call: " + ", ".join(
                  f"{k} {v:.1f}" for k, v in top), flush=True)
    dev = Counter()
    for e in events:
        if e.device_type == cuda and not e.name.startswith("op:"):
            dev[e.name] += e.device_time_total
    walk_us = sum(sum(v) for v in measured.values())
    print(f"{label} profile, whole walk: measured {walk_us:.1f} us over "
          f"{len(trace.records)} ops (each once timed), device kernels "
          f"{sum(dev.values()):.1f} us over both calls of each op; top "
          f"kernels: " + ", ".join(f"{k[:48]} {v:.1f}"
                                   for k, v in dev.most_common(6)),
          flush=True)
    out["walk_us"], out["device_us"] = walk_us, sum(dev.values())
    return out


def serve_spec(base_stats) -> tuple[dict, dict]:
    """Phase 5m: smollm-360m served with a draft pair off the graphed
    runners (``SPEC_RUNS``), each engine on the observability plane
    (metrics snapshot, Prometheus text and flight record in a temporary
    directory), the counters set to 0 just before each run and read
    just after; held by ``spec_launch_check``, ``spec_oracle``,
    ``check_plane`` and ``spec_against_eager``; the self-draft engine
    also samples op times, and its streams and state hashes must equal
    an unsampled run's.  Then the plane's own cost: 5b's plain serve
    with a real flight recorder against the default bundle, alternated.
    Returns (launches summed over the graphed runs, stats)."""
    import gc
    import tempfile
    import torch
    from repro_torch.launch import serve
    from repro_torch.runtime import executor
    n = int(LM_ARGS[LM_ARGS.index("--requests") + 1])
    base_streams = dict(enumerate(base_stats["streams"]))
    counters = lm_counters()
    total, stats = Counter(), {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags in SPEC_RUNS.items():
            label = f"5m {name}"
            stem = f"{tmp}/{name.replace(' ', '_')}"
            plane = ["--metrics-out", stem + ".json", "--flight-out",
                     stem + ".jsonl"]
            if name == "self-draft":
                plane += ["--sample-ops", str(SPEC_SAMPLE), "--dash-every",
                          str(SPEC_DASH)]
            for fn in counters.values():
                fn.launches = 0
            reset_matmul_paths()
            reset_flash_paths()
            counters["matmul"].b_transposed_launches = 0
            with SpecRecorder() as rec:
                res = serve.main(LM_ARGS + flags + plane)
            launches = {k: fn.launches for k, fn in counters.items()}
            bt = counters["matmul"].b_transposed_launches
            total.update(launches)
            eng, done = res["engine"], res["done"]
            if len(done) != n or not all(len(r.out_tokens) == 32
                                         for r in done):
                fail(f"{label}: served {len(done)} of {n} requests in full")
            if eng.n_prefill_recomputes or eng.n_prefills != n:
                fail(f"{label}: prefills {eng.n_prefills}, recomputes "
                     f"{eng.n_prefill_recomputes}")
            want = {"self-draft": eng.n_spec_accepted > 0,
                    "disagreeing draft": eng.n_spec_rollbacks > 0,
                    "chunked": (eng.n_prefill_chunks > 0
                                and eng.n_starved_ticks == 0)}[name]
            if not want:
                fail(f"{label}: accepted {eng.n_spec_accepted}, rollbacks "
                     f"{eng.n_spec_rollbacks}, chunks "
                     f"{eng.n_prefill_chunks}, starved "
                     f"{eng.n_starved_ticks}")
            calls = spec_launch_check(label, eng, rec, launches, bt)
            check_captured(label, eng.state.graphs.graphs, ("chunk",))
            check_captured(label, eng._draft_state.graphs.graphs,
                           ("decode",))
            events = check_plane(label, eng, res, stem + ".json",
                                 stem + ".jsonl")
            st = spec_oracle(label, eng, rec, res, events, base_streams)
            st.update(calls, tok_s=sum(len(r.out_tokens) for r in done)
                      / res["seconds"], capture_s=eng.capture_seconds,
                      accept=eng.n_spec_accepted / eng.n_spec_proposed,
                      proposed=eng.n_spec_proposed,
                      accepted=eng.n_spec_accepted,
                      rollbacks=eng.n_spec_rollbacks,
                      ticks=eng.n_decode_ticks)
            if name == "self-draft":
                hist = json.loads(Path(stem + ".json").read_text())[
                    "histograms"]
                for kind in ("matmul", "decode_attention"):
                    if f'op_time_us{{kind="{kind}"}}' not in hist:
                        fail(f"{label}: no op_time_us histogram for {kind}")
                by_kind = {}
                for e in events:
                    if e["ev"] == "op_sample":
                        if e["role"] != "draft":
                            fail(f"{label}: an op_sample of role "
                                 f"{e['role']}, want the draft round's")
                        by_kind.setdefault(e["kind"], []).append(
                            1e6 * e["measured_time_s"])
                st["op_us"] = {k: statistics.median(v)
                               for k, v in by_kind.items()}
                print(f"{label}: {st['samples']} sampled ticks; median "
                      f"sampled op time (us, one call between two "
                      f"synchronises) by kind: " + ", ".join(
                          f"{k} {v:.1f} ({len(by_kind[k])} ops)"
                          for k, v in sorted(st["op_us"].items())),
                      flush=True)
                st["profile"] = profile_sampled_walk(label, eng)
            with executor.disable_graphs(), SpecRecorder() as erec:
                eres = serve.main(LM_ARGS + flags)
            st.update(spec_against_eager(label, eng, rec, erec, eres, res))
            if name == "self-draft":
                hashes = [state_hash(eng.state),
                          state_hash(eng._draft_state)]
                streams = [r.out_tokens for r in done]
                res = eres = eng = rec = erec = None
                gc.collect()
                torch.cuda.empty_cache()
                res = serve.main(LM_ARGS + flags)
                eng = res["engine"]
                if ([r.out_tokens for r in res["done"]] != streams
                        or [state_hash(eng.state),
                            state_hash(eng._draft_state)] != hashes):
                    fail(f"{label}: the sampled run's streams or state "
                         f"hashes differ from the unsampled run's")
                print(f"{label}: the unsampled run's streams and state "
                      f"hashes (target {hashes[0][:12]}, draft "
                      f"{hashes[1][:12]}) equal the sampled run's",
                      flush=True)
            print(f"{label}: {st['tok_s']:.1f} tok/s (5b plain "
                  f"{base_stats['tok_s']:.1f}); acceptance "
                  f"{eng.n_spec_accepted} / {eng.n_spec_proposed} = "
                  f"{100 * st['accept']:.1f}% ({eng.n_spec_rollbacks} "
                  f"rollbacks, {eng.n_decode_ticks} ticks); capture "
                  f"{st['capture_s']:.3f} s", flush=True)
            stats[name] = st
            res = eres = eng = rec = erec = None
            gc.collect()
            torch.cuda.empty_cache()
        cost = {"default": [], "flight": []}
        for kind in ("default", "flight", "flight", "default"):
            res = serve.main(LM_ARGS + (["--flight-out", f"{tmp}/cost.jsonl"]
                                        if kind == "flight" else []))
            bundle = res["engine"].obs
            h = bundle.registry.snapshot()["histograms"]["tick_ms"]
            cost[kind].append((h["sum"] / h["count"],
                               32 * n / res["seconds"],
                               len(bundle.flight.events)))
            res = bundle = None
            gc.collect()
            torch.cuda.empty_cache()
    print("5m plane cost (5b's plain serve, alternated): mean tick ms and "
          "tok/s, default bundle " + ", ".join(
              f"{t:.3f} / {s:.1f}" for t, s, _ in cost["default"])
          + "; with a flight recorder " + ", ".join(
              f"{t:.3f} / {s:.1f} ({e} events)" for t, s, e in
              cost["flight"]), flush=True)
    stats["plane_cost"] = cost
    return dict(total), stats


# Phase 5n, the schedule autotuner (``core/autotune.py``) on the three
# Programs served above: 5a's zero-copy alexnet-owt Program (TPU_V5E) and
# 5i's SNOWFLAKE paper-faithful one at batch 8, and 5b's smollm-360m decode
# Program at 8 slots and max_len 512 after 8 prefills.  Per op, the
# TUNE_TOP_K candidates of least predicted cost (and the incumbent) are
# replayed, each timed on the device clock: the least of TUNE_REPEATS
# replays of a graph of ``executor.CLOCK_CALLS`` calls.
TUNE_TOP_K, TUNE_REPEATS = 3, 5


def tune_runs(device) -> dict:
    """5n's three tune calls by label, each taking the cache."""
    from repro_torch.configs import CNN_REGISTRY, get_config
    from repro_torch.core import SNOWFLAKE, TPU_V5E, autotune
    alex = CNN_REGISTRY["alexnet-owt"]
    kw = dict(top_k=TUNE_TOP_K, repeats=TUNE_REPEATS, seed=SEED,
              device=device)
    return {
        "5a alexnet-owt": lambda cache: autotune.tune_cnn(
            alex, batch=SLOTS, hw=TPU_V5E, cache=cache, **kw),
        "5i alexnet-owt@snowflake": lambda cache: autotune.tune_cnn(
            alex, batch=SLOTS, hw=SNOWFLAKE, paper_faithful=True,
            cache=cache, **kw),
        "5b smollm-360m": lambda cache: autotune.tune_lm_decode(
            get_config(LM_ARCH), slots=SLOTS, max_len=LM_MAX_LEN,
            cache=cache, **kw)}


def tuned_programs() -> dict:
    """The three Programs 5n tunes, as the compile entry points give
    them under whatever cache is active."""
    from repro_torch.configs import CNN_REGISTRY, get_config
    from repro_torch.core import SNOWFLAKE
    from repro_torch.models import cnn, transformer
    alex = CNN_REGISTRY["alexnet-owt"]
    return {"5a alexnet-owt": cnn.compile_program(alex, batch=SLOTS),
            "5i alexnet-owt@snowflake": cnn.compile_program(
                alex, batch=SLOTS, hw=SNOWFLAKE, paper_faithful=True),
            "5b smollm-360m": transformer.compile_program_pair(
                get_config(LM_ARCH), slots=SLOTS, max_len=LM_MAX_LEN)}


def graph_ms(graph, reps: int = 10) -> float:
    """Device ms of one replay of a captured ``torch.cuda.CUDAGraph``:
    the median of ``reps`` replays, each between two CUDA events
    (``executor.graph_seconds``).  Replaying the graph itself bypasses
    the runner, so it counts no launches."""
    import torch
    from repro_torch.runtime.executor import graph_seconds
    torch.cuda.synchronize()
    return 1e3 * statistics.median(graph_seconds(graph)
                                   for _ in range(reps))


def ab_ticks(device, untuned: dict, tuned: dict) -> dict:
    """Each untuned and tuned Program of 5n captured on one parameter
    tree and input (5b: one state, every slot prefilled with 256 rows
    from the seed, all slots dead in the tick so that replays leave it
    as it is), the two graphs replayed in turns (untuned, tuned, tuned,
    untuned, untuned, tuned): ``graph_ms`` of each."""
    import torch
    from repro_torch.configs import CNN_REGISTRY, get_config
    from repro_torch.models import cnn, init_params, param_defs
    from repro_torch.runtime import executor
    gen = torch.Generator(device=device).manual_seed(SEED)
    alex = CNN_REGISTRY["alexnet-owt"]
    params = init_params(cnn.param_defs(alex), gen, device)
    x = torch.randn((SLOTS, alex.input_hw, alex.input_hw, alex.input_ch),
                    generator=gen, device=device)
    graphs = {}
    for label in ("5a alexnet-owt", "5i alexnet-owt@snowflake"):
        graphs[label] = {}
        for kind, prog in (("untuned", untuned[label]),
                           ("tuned", tuned[label])):
            run = executor.graphed_runner(prog)
            run(params, x)
            run(params, x)
            graphs[label][kind] = next(g for g in run.store(params).graphs
                                       .values() if g is not None).graph
    label = "5b smollm-360m"
    cfg = get_config(LM_ARCH)
    pu, pt = untuned[label], tuned[label]
    lm_params = init_params(param_defs(cfg), gen, device)
    state = executor.init_program_state(pu, device)
    states = {"untuned": state,
              "tuned": state if pt.persistent == pu.persistent
              else executor.init_program_state(pt, device)}
    for st in {id(v): v for v in states.values()}.values():
        for slot in range(SLOTS):
            toks = torch.randint(0, cfg.vocab, (1, LM_MAX_LEN),
                                 generator=gen, device=device,
                                 dtype=torch.int32)
            executor.run_prefill(pu.prefill, lm_params, toks, st, slot,
                                 LM_MAX_LEN // 2)
    tokens = torch.zeros(SLOTS, dtype=torch.int32, device=device)
    dead = torch.zeros(SLOTS, dtype=torch.bool, device=device)
    graphs[label] = {}
    for kind, pair in (("untuned", pu), ("tuned", pt)):
        run = executor.graphed_decode_runner(pair.decode)
        run(lm_params, tokens, states[kind], dead)
        run(lm_params, tokens, states[kind], dead)
        graphs[label][kind] = next(
            g for k, g in states[kind].graphs.graphs.items()
            if g is not None and k[0] == id(pair.decode)).graph
    out = {}
    for label, pair in graphs.items():
        out[label] = {"untuned": [], "tuned": []}
        for kind in ("untuned", "tuned", "tuned", "untuned", "untuned",
                     "tuned"):
            out[label][kind].append(graph_ms(pair[kind]))
        print(f"5n {label}: device ms a graph replay on one parameter tree"
              + (" and state" if label == "5b smollm-360m" else "")
              + ", in turns: " + "; ".join(
                  f"{k} " + ", ".join(f"{ms:.4f}" for ms in v)
                  for k, v in out[label].items()), flush=True)
    return out


def in_turns(label: str, run, cache, device, repeat=None) -> dict:
    """``run()`` (a serving entry point, returning its result) untuned,
    tuned, tuned, untuned, untuned, tuned, each on a fresh engine: the
    items served per second (a CNN's over ``repeat(res)``, which serves
    the images again on the same engine, past the first call and the
    capture)."""
    from repro_torch.core import autotune
    rates = {"untuned": [], "tuned": []}
    for tuned in (False, True, True, False, False, True):
        if tuned:
            autotune.activate(cache, device=device)
        try:
            res = run()
        finally:
            autotune.deactivate()
        n, secs = (sum(len(r.out_tokens) for r in res["done"]),
                   res["seconds"])
        if repeat is not None:
            t0 = time.perf_counter()
            n = repeat(res)
            secs = time.perf_counter() - t0
        rates["tuned" if tuned else "untuned"].append(n / secs)
        del res
    print(f"5n {label} in turns, per second: " + "; ".join(
        f"{k} " + ", ".join(f"{r:.1f}" for r in vs)
        for k, vs in rates.items()), flush=True)
    return rates


def serve_again(res) -> int:
    """The CNN result's images served ``CNN_REPEATS`` more times on its
    engine; returns how many."""
    from repro_torch.serving import Request
    for _ in range(CNN_REPEATS):
        for i, img in enumerate(res["images"]):
            res["engine"].submit(Request(uid=i, prompt=img))
        res["engine"].run_until_drained()
    return CNN_REPEATS * len(res["images"])


def tune_phase(device) -> tuple[dict, dict]:
    """Phase 5n: trace, calibrate, replay and pin 5a's, 5i's and 5b's
    Programs on the device clock (counters set to 0 just before, read
    after the second pass), print each one's per-op decisions and its
    measured-against-predicted error table before and after calibration;
    a second pass over the cache reloaded from its file must measure
    nothing.  Each tuned op's replay is then held to its plain version
    (f32 1e-4, bf16 2^-7), and with the cache active the three are served
    again through the same entry points as 5a, 5i and 5b, at their bars
    (classes against the plain path, teacher-forced logits, graphed =
    eager bit for bit), tuned against untuned in turns: each Program's
    graph on one parameter tree (``ab_ticks``) and each entry point's
    rate (``in_turns``).  Returns (launches, max errors by kernel)."""
    import tempfile
    import torch
    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.core import SNOWFLAKE, autotune
    from repro_torch.core.cost import format_error_table
    from repro_torch.kernels.conv2d.kernel import (conv2d_strips_cuda,
                                                   conv2d_virtual_cuda)
    from repro_torch.launch import serve
    from repro_torch.models import cnn
    from repro_torch.runtime import executor, replay
    wrappers = dict(lm_counters(), conv2d_virtual=conv2d_virtual_cuda,
                    conv2d_strips=conv2d_strips_cuda)
    runs = tune_runs(device)
    untuned = tuned_programs()
    path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_tune_"),
                        "tuned.json")
    cache = autotune.TunedCache.load(path)
    for fn in wrappers.values():
        fn.launches = 0
    reports = {}
    for label, tune in runs.items():
        t0 = time.perf_counter()
        rep = tune(cache)
        reports[label] = rep
        print(f"5n {label}: {rep.summary()}")
        print(f"5n {label}: tuned in {time.perf_counter() - t0:.1f} s; "
              f"measured (device clock) against predicted, before "
              f"(analytic: the hardware model's roofline) and after "
              f"calibration:\n{format_error_table(rep.error_rows)}",
              flush=True)
        done = [r for r in rep.results if not r.cached]
        if not rep.n_measurements or not rep.error_rows or not all(
                r.winner_time_s and r.incumbent_time_s for r in done):
            fail(f"5n {label}: {rep.n_measurements} measurements, "
                 f"{len(rep.error_rows)} error rows")
    cache.save()
    again = autotune.TunedCache.load(path)
    if again.entries != cache.entries:
        fail("5n: the reloaded cache's entries differ from the tuned ones")
    for label, tune in runs.items():
        rep = tune(again)
        if rep.n_measurements or not all(r.cached for r in rep.results):
            fail(f"5n {label}: the second pass measured "
                 f"{rep.n_measurements} times")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"5n: second pass over the reloaded cache ({len(again.entries)} "
          f"entries): 0 replay measurements; launches {launches}",
          flush=True)
    for label in ("5a alexnet-owt", "5i alexnet-owt@snowflake"):
        convs = [r for r in reports[label].results
                 if r.kind == "conv2d" and not r.cached]
        moved = [f"{r.name} {autotune.decisions(r.incumbent)} -> "
                 f"{autotune.decisions(r.winner)}" for r in convs
                 if (r.winner["strip_storage"], r.winner["dataflow"])
                 != (r.incumbent["strip_storage"], r.incumbent["dataflow"])]
        print(f"5n {label}: {len(moved)} of {len(convs)} convs change strip "
              f"storage or loop order" + "".join(f"; {m}" for m in moved))
    # Every tuned op's replay (the winner's decisions, seeded operands)
    # against its plain version: comparison launches, outside the count.
    # A decode op draws unit-variance operands, where its scores spread
    # by about one: at the default std 0.1 its softmax is near uniform
    # and its outputs (about 0.006) lie under the bf16 bar, so a wrong
    # scale or softmax would pass.
    errs, peak = {}, {}
    for label, rep in reports.items():
        for r in rep.results:
            if r.cached:
                continue
            kw = dict(candidate=r.candidate, seed=SEED, device=device,
                      scale=1.0 if r.kind == "decode_attention" else 0.1)
            got = replay.replay_outputs(r.record, impl="cuda", **kw)
            want = replay.replay_outputs(r.record, impl="reference", **kw)
            bf16 = got.dtype == torch.bfloat16
            err = max_err(got, want, BF16_TOL if bf16 else TOL)
            kernel = r.kind
            if r.kind == "conv2d":
                kernel = ("conv2d_strips" if r.winner["strip_storage"]
                          == "materialized" else "conv2d_virtual")
            errs[kernel] = max(errs.get(kernel, 0.0), err)
            peak[kernel] = max(peak.get(kernel, 0.0),
                               want.float().abs().max().item())
    print(f"5n: every tuned op's replay against its plain version, max "
          f"|err| by kernel {errs}, max |plain| {peak}", flush=True)

    autotune.activate(again, device=device)
    try:
        tuned = tuned_programs()
        for label, prog in tuned.items():
            before = untuned[label]
            if label == "5b smollm-360m":
                prog, before = prog.decode, before.decode
            changed = sum(a.trace() != b.trace()
                          for a, b in zip(prog.ops, before.ops))
            if prog is before or len(prog.ops) != len(before.ops):
                fail(f"5n {label}: the compile served the untuned Program")
            print(f"5n {label}: the tuned Program differs from the untuned "
                  f"one in {changed} of {len(prog.ops)} ops")
        a_launches, a_img_s, _ = serve_alexnet(device, "5n 5a tuned")
        i_launches, *_ = serve_paper_faithful(
            device, a_img_s, label="5n 5i tuned", turns=False)
        n_lm = int(LM_ARGS[LM_ARGS.index("--requests") + 1])
        lm_launches, _, eng, _ = serve_lm(
            "5n 5b tuned", lambda: serve.main(LM_ARGS), n_lm)
        if eng.program is not tuned["5b smollm-360m"]:
            fail("5n 5b tuned: the engine did not serve the tuned pair")
    finally:
        autotune.deactivate()
    # The served decode Program on the engine's last state (8 slots of
    # 32-448 prompt rows and 32 new tokens), traced on both clocks.
    tokens = torch.zeros(SLOTS, dtype=torch.int32, device=device)
    clocks = {}
    for clock in ("host", "device"):
        trace = executor.trace_program(eng.program.decode, eng.params,
                                       tokens, repeats=TUNE_REPEATS,
                                       clock=clock, state=eng.state)
        by_kind = {}
        for r in trace.records:
            by_kind.setdefault(r.kind, []).append(r.measured_time_s)
        clocks[clock] = {k: 1e6 * sum(v) / len(v) for k, v in by_kind.items()}
    print("5n 5b: the served decode Program traced, mean us an op, host / "
          "device clock: " + ", ".join(
              f"{k} {clocks['host'][k]:.2f} / {clocks['device'][k]:.2f} "
              f"({clocks['host'][k] / clocks['device'][k]:.1f}x)"
              for k in clocks["device"]), flush=True)
    for k in wrappers:
        launches[k] += sum(p.get(k, 0) for p in (a_launches, i_launches,
                                                 lm_launches))
    ab_ticks(device, untuned, tuned)
    # Each run compiles under the cache in_turns activates or not.
    in_turns("5a alexnet-owt img/s", lambda: serve.serve_cnn(
        "alexnet-owt", slots=SLOTS, requests=REQUESTS, device=device,
        seed=SEED), again, device, serve_again)
    in_turns("5i alexnet-owt@snowflake img/s", lambda: serve.serve_cnn(
        "alexnet-owt", slots=SLOTS, requests=REQUESTS, device=device,
        seed=SEED, program=cnn.compile_program(
            CNN_REGISTRY["alexnet-owt"], batch=SLOTS, hw=SNOWFLAKE,
            paper_faithful=True)), again, device, serve_again)
    in_turns("5b smollm-360m tok/s", lambda: serve.main(LM_ARGS), again,
             device)
    return launches, errs


START = time.perf_counter()


# Phase 5t: the sharded steps (``launch/steps.py::build_step``) on a
# world-of-one NCCL mesh, smollm-360m at 5f's width, depth and batch.
SHARDED_STEPS, SHARDED_DECODE = 2, 8
# The serving strategies: tp and auto run the split path at a group of
# one, fsdp (its rows on "model") the weight-gathered one.
SHARDED_SERVING = ("tp", "fsdp", "auto")


def sharded_phase(device, train_stats) -> tuple[dict, dict]:
    """Phase 5t: NCCL initialised as a world of one on the card (a
    ``HashStore``, no port) and a (1, 1) ("data", "model") mesh.  Under
    each of tp, fsdp and auto, SHARDED_STEPS sharded train steps of
    smollm-360m at full width and depth (bf16, f32 moments, 5f's batch 8
    x 512, SyntheticLM batches), each held bit for bit against
    ``build_train_step`` run eagerly (``executor.disable_graphs()``)
    from the same params: loss, grad norm, lr and every updated param
    and moment leaf (tp and auto through the split code at a group of
    one, its counters read; fsdp weight-gathered), then one more step a
    side under the profiler and one sharded step's resident and peak
    memory (auto, for 5v); under each of SHARDED_SERVING one sharded
    prefill (8 x 512; a second one timed) and SHARDED_DECODE sharded
    decode steps, bit for bit against the legacy ``forward(return_cache)`` and
    ``decode_step`` on the same cache (tp and auto through the split
    code at a group of one, its counters read; fsdp weight-gathered,
    one call a side profiled and its peak memory read, for 5v);
    both ring collective matmuls at the group of one at smollm's w_up
    shape (M = 4096, K = 960, N = 2560, bf16), through the matmul
    kernel, against the plain matmul at 2^-7.  The launch and flash
    path counters are read around each sharded call and ring call (the
    main path), never around the single-device and legacy calls they
    are compared with.  Returns (launches, stats)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.hw import MeshDescriptor
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.matmul import matmul_ref
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_from_descriptor
    from repro_torch.models import init_params, transformer
    from repro_torch.optim import AdamW
    from repro_torch.parallel import (all_gather_matmul, make_plan,
                                      matmul_reduce_scatter)
    from repro_torch.parallel.placement import gather
    from repro_torch.parallel.split import COUNTS as split_counts
    from repro_torch.runtime import executor
    counters = lm_counters()
    cfg = get_config(LM_ARCH)
    L = cfg.n_layers
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=device)
    init_s = time.perf_counter() - t0
    if dist.get_backend() != "nccl":
        fail(f"5t: the process group's backend is {dist.get_backend()}")
    desc = MeshDescriptor((1, 1), ("data", "model"))
    mesh = make_mesh_from_descriptor(desc, "cuda")
    stats = {"init_s": init_s, "steps": {}}
    launches = {k: 0 for k in counters}
    paths = [{"mma": 0, "simt": 0}, {"mma": 0, "simt": 0}]

    def synced(call, main=False):
        """(call's result, its ms to a device synchronise); with
        ``main`` its kernel launches and flash paths are the phase's."""
        before = {k: fn.launches for k, fn in counters.items()}
        p0 = flash_paths()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        if main:
            for k, fn in counters.items():
                launches[k] += fn.launches - before[k]
            for got, a, b in zip(paths, p0, flash_paths()):
                for k in got:
                    got[k] += b[k] - a[k]
        return out, ms

    def peak_gb(call):
        """(GB allocated before ``call``, its peak GB above that)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        return (before / 1e9,
                (torch.cuda.max_memory_allocated() - before) / 1e9)

    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in data.batch_at(i).items()}
               for i in range(SHARDED_STEPS)]
    shape = ShapeSpec("5t train", TRAIN_SEQ, TRAIN_BATCH, "train")
    same = True
    for strategy in ("tp", "fsdp", "auto"):
        plan = make_plan(cfg, shape, desc, strategy)
        opt = AdamW()
        bundle = steps.build_step(cfg, shape, plan, mesh, optimizer=opt)
        full = init_params(transformer.param_defs(cfg),
                           torch.Generator(device).manual_seed(SEED))
        params = steps.distribute_tree(full, bundle.specs["params"], mesh)
        state = steps.distribute_tree(opt.init(full),
                                      bundle.specs["opt_state"], mesh)
        eager_state = opt.init(full)
        eager = steps.build_train_step(cfg, opt)
        ms, ems, metrics = [], [], []
        split_counts.clear()
        for b in batches:
            # The metrics alone are kept: a name left bound to the
            # returned state would keep it alive past its ``del``.
            m, t = synced(lambda: bundle.fn(params, state, b)[2], True)
            ms.append(t)
            with executor.disable_graphs():
                em, t = synced(lambda: eager(full, eager_state, b)[2])
            ems.append(t)
            metrics.append((m, em))
        # tp and auto train through the split code at a group of one (no
        # collective; the recompute under remat launches flash again),
        # fsdp weight-gathered.
        case = {"tp": "whole", "auto": "unsplit"}.get(strategy)
        want_counts = {} if case is None else {
            f"flash:{case}:15/5": 2 * L * SHARDED_STEPS}
        if dict(split_counts) != want_counts:
            fail(f"5t train {strategy}: split counters {dict(split_counts)}"
                 f", want {want_counts}")
        ok_metrics = all(_tree_equal([m[k] for k in ("loss", "grad_norm",
                                                     "lr")],
                                     [em[k] for k in ("loss", "grad_norm",
                                                      "lr")])
                         for m, em in metrics)
        ok_state = (_tree_equal(steps.gather_tree(params), full)
                    and _tree_equal(steps.gather_tree(state), eager_state))
        same = same and ok_metrics and ok_state
        if strategy == "auto":
            # One more step a side under the profiler: where the sharded
            # step's extra time goes (not counted: past the checks).
            def eager_step():
                with executor.disable_graphs():
                    return eager(full, eager_state, batches[0])
            stats["profiles"] = (
                profile_train("5t sharded step (auto)", lambda: bundle.fn(
                    params, state, batches[0]), ms[-1]),
                profile_train("5t eager single-device step", eager_step,
                              ems[-1]))
            # Its resident and peak memory, for 5v's split train step,
            # with the single-device params and state freed first.
            del eager_state, eager, full
            torch.cuda.empty_cache()
            stats["train_gb"] = peak_gb(lambda: bundle.fn(
                params, state, batches[0]))
            full = eager_state = eager = None
        stats["steps"][strategy] = {
            "ms": ms, "eager_ms": ems,
            "layout": plan.decisions.get("layout", strategy),
            "losses": [float(m["loss"]) for m, _ in metrics]}
        print(f"5t train {strategy} ({stats['steps'][strategy]['layout']}):"
              f" losses {stats['steps'][strategy]['losses']}; sharded step "
              f"ms {[round(t, 2) for t in ms]} against the eager "
              f"single-device step {[round(t, 2) for t in ems]}; metrics "
              f"bit-equal {ok_metrics}, params and moments bit-equal "
              f"{ok_state}", flush=True)
        del params, state, eager_state, full, bundle, eager
        torch.cuda.empty_cache()

    # Prefill and decode under tp and auto (the split path at a group of
    # one) and fsdp (its rows on "model": the weight-gathered path),
    # against the legacy path.
    pshape = ShapeSpec("5t prefill", TRAIN_SEQ, TRAIN_BATCH, "prefill")
    dshape = ShapeSpec("5t decode", TRAIN_SEQ, TRAIN_BATCH, "decode")
    full = init_params(transformer.param_defs(cfg),
                       torch.Generator(device).manual_seed(SEED))
    head = full["embed"].T if cfg.tie_embeddings else full["lm_head"]
    gen = torch.Generator(device).manual_seed(SEED + 5)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                         generator=gen, device=device)
    dtoks = [torch.randint(0, cfg.vocab, (TRAIN_BATCH,), generator=gen,
                           device=device) for _ in range(SHARDED_DECODE)]

    def legacy_prefill():
        with torch.no_grad():
            out = transformer.forward(full, toks, cfg, return_cache=True,
                                      return_hidden=True,
                                      cache_len=TRAIN_SEQ)
        return out["hidden"][:, -1] @ head, out["cache"]

    ok_prefill = ok_decode = True
    serving = {}
    for strategy in SHARDED_SERVING:
        pre = steps.build_step(cfg, pshape,
                               make_plan(cfg, pshape, desc, strategy), mesh)
        dec = steps.build_step(cfg, dshape,
                               make_plan(cfg, dshape, desc, strategy), mesh)
        params = steps.distribute_tree(full, pre.specs["params"], mesh)
        dparams = steps.distribute_tree(full, dec.specs["params"], mesh)
        split_counts.clear()
        # Each side twice: the first call checked, the second timed (the
        # first carries one-time costs).
        (logits, cache), first_ms = synced(
            lambda: pre.fn(params, {"tokens": toks}), True)
        (want, wcache), _ = synced(legacy_prefill)
        pre_ms = synced(lambda: pre.fn(params, {"tokens": toks}), True)[1]
        legacy_ms = synced(legacy_prefill)[1]
        ok_p = (_tree_equal(gather(logits), want)
                and _tree_equal(steps.gather_tree(cache), wcache))
        dcache = steps.distribute_tree(wcache, dec.specs["cache"], mesh)
        dec_ms, leg_ms, ok_d = [], [], True
        for t in dtoks:
            (logits, dcache), ms_ = synced(
                lambda: dec.fn(dparams, dcache, {"tokens": t}), True)
            with torch.no_grad():
                (want, wcache), lms = synced(lambda: transformer.decode_step(
                    full, wcache, t, cfg))
            dec_ms.append(ms_)
            leg_ms.append(lms)
            ok_d = ok_d and _tree_equal(gather(logits), want)
        ok_d = ok_d and _tree_equal(steps.gather_tree(dcache), wcache)
        ok_prefill, ok_decode = ok_prefill and ok_p, ok_decode and ok_d
        counts = dict(split_counts)
        # tp puts every class on "model" (whole heads at a group of one);
        # auto's mixed plan on a (1, 1) mesh keeps every class on "data"
        # (nothing forced onto an idle "model" axis): no split weight;
        # fsdp's rows lie on "model": weight-gathered, nothing counted.
        case = {"tp": "whole", "auto": "unsplit"}.get(strategy)
        want_counts = {} if case is None else {
            f"flash:{case}:15/5": 2 * L,
            f"decode:{case}:15/5": SHARDED_DECODE * L}
        if counts != want_counts:
            fail(f"5t {strategy}: split counters {counts}, want "
                 f"{want_counts}")
        st = {"prefill_ms": pre_ms, "first_prefill_ms": first_ms,
              "legacy_prefill_ms": legacy_ms,
              "decode_ms": statistics.median(dec_ms[1:]),
              "legacy_decode_ms": statistics.median(leg_ms[1:])}
        if strategy == "fsdp":
            # The weight-gathered path's device time and peak memory, one
            # call a side, for 5v's rank to stand beside.
            st["profiles"] = {
                "prefill": profile_train(
                    "5t weight-gathered prefill (fsdp)",
                    lambda: pre.fn(params, {"tokens": toks}), pre_ms),
                "decode": profile_train(
                    "5t weight-gathered decode step (fsdp)",
                    lambda: dec.fn(dparams, dcache, {"tokens": dtoks[0]}),
                    st["decode_ms"])}
            st["peak_gb"] = {
                "prefill": peak_gb(lambda: pre.fn(params,
                                                  {"tokens": toks})),
                "decode": peak_gb(lambda: dec.fn(
                    dparams, dcache, {"tokens": dtoks[0]}))}
        serving[strategy] = st
        print(f"5t prefill 8 x {TRAIN_SEQ} ({strategy}, "
              f"{'split at a group of one' if case else 'weight-gathered'}"
              f"): {pre_ms:.2f} ms sharded (the first call "
              f"{first_ms:.2f}), {legacy_ms:.2f} ms legacy forward; logits "
              f"and cache bit-equal {ok_p}; {SHARDED_DECODE} decode steps: "
              f"sharded {[round(x, 2) for x in dec_ms]} ms, legacy "
              f"{[round(x, 2) for x in leg_ms]} ms; logits and cache "
              f"bit-equal {ok_d}; split counters {counts}", flush=True)
        del params, dparams, cache, dcache, wcache, pre, dec
    a, wg, tp = serving["auto"], serving["fsdp"], serving["tp"]
    print(f"5t serving, the weight-gathered path (fsdp) less the split one "
          f"(tp; no gather at a group of one), then the split one less the "
          f"legacy path: prefill {wg['prefill_ms'] - tp['prefill_ms']:.2f} "
          f"and {tp['prefill_ms'] - tp['legacy_prefill_ms']:.2f} ms, decode "
          f"step {wg['decode_ms'] - tp['decode_ms']:.2f} and "
          f"{tp['decode_ms'] - tp['legacy_decode_ms']:.2f} ms", flush=True)
    stats.update(serving=serving, prefill_ms=a["prefill_ms"],
                 legacy_prefill_ms=a["legacy_prefill_ms"],
                 decode_ms=a["decode_ms"],
                 legacy_decode_ms=a["legacy_decode_ms"])
    del full

    # The ring collective matmuls at the group of one, smollm's w_up.
    group = mesh.get_group("model")
    gen = torch.Generator(device).manual_seed(SEED + 6)
    M, K, N = TRAIN_BATCH * TRAIN_SEQ, cfg.d_model, cfg.d_ff
    x = torch.randn(M, K, generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn(K, N, generator=gen, device=device) * K ** -0.5).to(
        torch.bfloat16)
    ref = matmul_ref(x, w)
    before = launches["matmul"]
    ring_err = max(max_err(synced(lambda: all_gather_matmul(x, w, group),
                                  True)[0], ref, BF16_TOL),
                   max_err(synced(lambda: matmul_reduce_scatter(x, w, group),
                                  True)[0], ref, BF16_TOL))
    ring_launches = launches["matmul"] - before
    ring = {"agm_ms": time_ms(lambda: all_gather_matmul(x, w, group)),
            "mrs_ms": time_ms(lambda: matmul_reduce_scatter(x, w, group)),
            "plain_ms": time_ms(lambda: matmul_ref(x, w)),
            "library_ms": time_ms(lambda: x @ w)}
    stats.update(ring=ring, ring_err=ring_err)
    print(f"5t ring matmuls at a group of one ({M} x {K} x {N}, bf16): "
          f"{ring_launches} matmul launches, max |err| {ring_err:.3e} "
          f"against the plain matmul (tolerance {BF16_TOL}); all_gather_"
          f"matmul {ring['agm_ms']:.4f} ms, matmul_reduce_scatter "
          f"{ring['mrs_ms']:.4f} ms, plain {ring['plain_ms']:.4f} ms, "
          f"library (bf16 `@`, cuBLAS) {ring['library_ms']:.4f} ms")
    t0 = time.perf_counter()
    dist.destroy_process_group()
    want = {k: 0 for k in counters}
    n_serving = len(SHARDED_SERVING)
    want.update(flash_attention=2 * L * SHARDED_STEPS * 3 + 2 * n_serving * L,
                flash_attention_bwd=L * SHARDED_STEPS * 3,
                decode_attention=n_serving * L * SHARDED_DECODE, matmul=2)
    print(f"5t: NCCL init {init_s:.3f} s, destroy "
          f"{time.perf_counter() - t0:.3f} s; launches on the sharded "
          f"paths {launches}, want {want}", flush=True)
    if launches != want or ring_launches != 2:
        fail(f"5t: launch counts {launches} != {want}")
    check_flash_paths("5t", want["flash_attention"],
                      want["flash_attention_bwd"], got=paths)
    if not same:
        fail("5t: a sharded train step is not bitwise equal to the eager "
             "single-device step")
    if not (ok_prefill and ok_decode):
        fail("5t: the sharded prefill or decode is not bitwise equal to "
             "the legacy path")
    stats["eager_5f_ms"] = train_stats["eager_ms"]
    stats["graphed_5f_ms"] = train_stats["graphed_ms"]
    return launches, stats


# Phase 5u: the dry-run tooling (``launch/dryrun.py``, ``launch/report.py``,
# ``core/step_analysis.py``, ``core/roofline.py``): smollm-360m's cells
# through the CLI, and 5t's own cell counted against the card.
# One CLI process a cell, all four at once (CPU work; nothing is timed
# meanwhile): train_4k, prefill_32k, decode_32k on 16x16; train_4k on
# 2x16x16.
DRYRUN_RUNS = tuple(("--shape", s, "--mesh", "single")
                    for s in ("train_4k", "prefill_32k", "decode_32k")) + (
    ("--shape", "train_4k", "--mesh", "multi"),)
DRYRUN_CELLS = 4            # train_4k, prefill_32k, decode_32k; train_4k
DRYRUN_TIMEOUT = 600        # seconds a CLI run may take
# The counted FLOPs of 5t's cell against ``plain_train_flops``.
FLOP_COUNT_TOL = 0.05


def plain_train_flops(cfg, batch: int, seq: int, remat: bool) -> float:
    """The FLOPs of one plain-path training step of a dense LM, from its
    config: ``dryrun.analytic_flops``' 6·N·D less the embedding's share
    (a gather, no product), plus the forward that remat recomputes in
    the blocks (2·N_blocks·D; the head is not recomputed), plus the
    attention's two products over the whole L x L (the plain path masks,
    it does not skip), once forward, twice backward, once more under
    remat."""
    import math
    from repro_torch.launch.dryrun import analytic_flops
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import param_defs
    leaves = _named_leaves(param_defs(cfg))
    n_embed = math.prod(leaves["embed"].shape)
    n_blocks = sum(math.prod(d.shape) for k, d in leaves.items()
                   if k.startswith("blocks/"))
    tokens = batch * seq
    attn = (4.0 * batch * cfg.n_heads * seq * seq * cfg.head_dim
            * cfg.n_layers)
    return (analytic_flops(cfg, ShapeSpec("", seq, batch, "train"))
            - 6.0 * n_embed * tokens
            + (2.0 * n_blocks * tokens if remat else 0.0)
            + (4 if remat else 3) * attn)


def dryrun_phase(peaks, sharded) -> dict:
    """Phase 5u, CPU work beside the card: no kernel, no launch.

    (a) 5t's own cell counted by ``analyze_step`` on a fake world of one:
    smollm-360m on the (1, 1) mesh, the sharded train step of 8 x 512 in
    bf16 with f32 moments, ``impl="reference"``, under
    ``FakeTensorMode``.  Its FLOPs must lie within FLOP_COUNT_TOL of
    ``plain_train_flops`` (a counter that missed the backward, the
    remat forward or the attention, or counted twice, falls outside),
    and FLOPs / the bf16 peak must be at or under 5t's profiled device
    time of the auto step (a counter that overcounts passes it).  Its
    bound on this card, max(FLOPs / the bf16 peak, HBM bytes / the HBM
    rate) (one rank: no collective term), is printed beside 5t's
    measured sharded steps, gating nothing: the bytes are the plain
    path's unfused ones, attention scores included, more than the
    kernels' path moves.
    (b) The CLI as a user runs it on a host without the card, once 5t
    has ended (nothing is timed meanwhile), one process a cell, all at
    once: ``python -m repro_torch.launch.dryrun --arch smollm-360m
    --shape S --mesh single`` for train_4k, prefill_32k and decode_32k
    (16x16) and ``--shape train_4k --mesh multi`` (2x16x16), a fake world
    of 512 ranks over fake tensors: each run exits 0, every record
    error-free with hlo_flops > 0; then ``python -m
    repro_torch.launch.report`` over their records, both tables holding
    a row for each cell.  Returns the
    cells' records, the count and the bound."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.hw import MeshDescriptor
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_from_descriptor
    from repro_torch.optim import AdamW
    from repro_torch.parallel import make_plan
    t_phase = time.perf_counter()
    # (a) 5t's cell, here.
    dryrun.fake_world(1)
    desc = MeshDescriptor((1, 1), ("data", "model"))
    cfg = get_config(LM_ARCH)
    shape = ShapeSpec("5t train", TRAIN_SEQ, TRAIN_BATCH, "train")
    try:
        _, st = dryrun.count_step(
            cfg, shape, make_plan(cfg, shape, desc),
            make_mesh_from_descriptor(desc, "cpu"), optimizer=AdamW())
    finally:
        dist.destroy_process_group()
    count_s = time.perf_counter() - t_phase
    want = plain_train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ,
                             remat=cfg.n_layers >= 16)
    flop_ratio = st.flops / want
    flop_ms = 1e3 * st.flops / peaks["bfloat16"]
    byte_ms = 1e3 * st.hbm_bytes / peaks["hbm"]
    bound = max(flop_ms, byte_ms)
    measured = {k: v["ms"] for k, v in sharded["steps"].items()}
    profile = (sharded.get("profiles") or [None])[0]
    device_ms = profile["device_ms"] if profile else None
    print(f"5u 5t's cell counted in {count_s:.1f} s: {st.flops:.4e} FLOPs "
          f"({flop_ratio:.4f} x the {want:.4e} of plain_train_flops, "
          f"within {FLOP_COUNT_TOL}), {st.hbm_bytes:.4e} HBM bytes, "
          f"collectives {st.coll_counts} ({st.coll_link_bytes:.0f} link "
          f"bytes), memory {st.memory}; on this card FLOPs / bf16 peak "
          f"{flop_ms:.2f} ms against 5t's profiled auto step "
          + (f"{device_ms:.2f} ms of device time" if device_ms
             else "(not measured: the profiler saw no device time)")
          + f"; bound max(FLOPs, bytes) {bound:.2f} ms (bytes "
          f"{byte_ms:.2f}, the plain path's unfused), 5t's sharded "
          "steps, ms / bound: " + "; ".join(
              f"{k} " + ", ".join(f"{t:.2f} / {t / bound:.2f}" for t in v)
              for k, v in measured.items()), flush=True)
    if abs(flop_ratio - 1.0) > FLOP_COUNT_TOL:
        fail(f"5u: the counted FLOPs of 5t's cell are {flop_ratio:.4f} x "
             f"plain_train_flops, outside 1 +- {FLOP_COUNT_TOL}")
    if device_ms is None:
        fail("5u: 5t's profiled step has no device time to hold the "
             "counted FLOPs against")
    if flop_ms > device_ms:
        fail(f"5u: the counted FLOPs take {flop_ms:.2f} ms at the bf16 "
             f"peak, more than 5t's profiled {device_ms:.2f} ms")
    # (b) the CLI, a process a cell, all at once; then the report.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_5u_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out = os.path.join(tmp, "dryrun_results.jsonl")
    t_cells = time.perf_counter()
    procs = []
    try:
        for i, extra in enumerate(DRYRUN_RUNS):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", LM_ARCH, *extra, "--out", f"{out}.{i}"]
            procs.append((extra, subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        records = []
        for i, (extra, proc) in enumerate(procs):
            text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
            print(f"5u dryrun {' '.join(extra)}: rc {proc.returncode} at "
                  f"{time.perf_counter() - t_cells:.1f} s\n" + text.strip(),
                  flush=True)
            if proc.returncode != 0:
                fail(f"5u: the dry-run {' '.join(extra)} exited "
                     f"{proc.returncode}")
            with open(f"{out}.{i}") as f:
                records += [json.loads(line) for line in f if line.strip()]
        cells_s = time.perf_counter() - t_cells
        rows = [r for r in records if not r.get("skipped")]
        skipped = []                # each run writes the arch's skips
        for r in records:
            if r.get("skipped") and r not in skipped:
                skipped.append(r)
        with open(out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows + skipped)
        bad = [r for r in rows if "error" in r or not r.get("hlo_flops", 0) > 0]
        if len(rows) != DRYRUN_CELLS or bad:
            fail(f"5u: {len(rows)} records for {DRYRUN_CELLS} cells, "
                 f"errors or no FLOPs in {bad}")
        rep = subprocess.run([sys.executable, "-m", "repro_torch.launch.report",
                              out], cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=120)
        print(f"5u report (rc {rep.returncode}):\n{rep.stdout}{rep.stderr}",
              flush=True)
        n_rows = sum(line.startswith(f"| {LM_ARCH} |")
                     for line in rep.stdout.splitlines())
        if rep.returncode != 0 or n_rows != 2 * DRYRUN_CELLS:
            fail(f"5u: the report exited {rep.returncode} with {n_rows} "
                 f"rows, want {2 * DRYRUN_CELLS}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    for r in rows:
        m = r["memory_analysis"]
        print(f"5u {r['arch']} {r['shape']} {r['mesh']} ({r['strategy']}, "
              f"{r['decisions'].get('layout', '-')}): traced "
              f"{r['compile_s']} s; per rank {r['hlo_flops'] / r['chips']:.4e}"
              f" FLOPs ({r['useful_ratio']:.4f} of them the model's), "
              f"{r['hlo_bytes'] / r['chips']:.4e} HBM bytes, "
              f"{r['coll_link_bytes_per_chip']:.4e} link bytes "
              f"{r['coll_counts']}; arguments "
              f"{m['argument_size_in_bytes'] / 1e9:.3f} GB, temporaries "
              f"{m['temp_size_in_bytes'] / 1e9:.3f} GB", flush=True)
    stats = {"rows": rows, "flops": st.flops, "flop_ratio": flop_ratio,
             "bound_ms": bound, "flop_ms": flop_ms, "byte_ms": byte_ms,
             "measured_ms": measured, "device_ms": device_ms,
             "count_s": count_s, "cells_s": cells_s,
             "seconds": time.perf_counter() - t_phase}
    print(f"5u: 5t's cell counted in {count_s:.1f} s, {len(rows)} dry-run "
          f"cells in {cells_s:.1f} s; phase {stats['seconds']:.1f} s",
          flush=True)
    return stats


# Phase 5v: the split prefill, decode and train step (``parallel/split.py``)
# as rank 0 of a fake world of SPLIT_WORLD ranks on the card, smollm-360m
# at full width and depth: 5 divides its 15 query and 5 KV heads.
SPLIT_WORLD = 5
SPLIT_DECODE = 8
SPLIT_TRAIN_STEPS = 4       # 1 eager step, then 3 more, every launch held
SPLIT_TIMEOUT = 300         # seconds the subprocess may take
SPLIT_HEADS = (15 // SPLIT_WORLD, 5 // SPLIT_WORLD)


def split_child() -> int:
    """5v's body, in a process of its own (one default process group a
    process): a fake process group of SPLIT_WORLD ranks, this process
    rank 0, on the card (``launch/dryrun.fake_world``: collectives return
    at once and move nothing), and a (1, SPLIT_WORLD) ("data", "model")
    mesh over it.  First the collectives the split uses, on CUDA tensors.
    Then, under tp and auto, rank 0's blocks of seeded full weights
    (``distribute_tree``: each rank cuts its own block, no communication)
    through one prefill of 8 x 512 and SPLIT_DECODE decode steps on its
    cache: every flash and decode launch held against its plain version
    on the same inputs at 2^-7, its head counts read, the launches and
    the split's counters exact; then the prefill and a decode step timed
    again, profiled, and their peak memory.  The train leg, under tp and
    auto: rank 0's blocks and f32 moments (5t's auto optimizer) through
    SPLIT_TRAIN_STEPS train steps of 8 x 512 (SyntheticLM, 5t's
    batches), every flash forward launch held against its plain version
    at 2^-7 and every backward launch at one bf16 ulp plus the f32
    bound (``max_err_ulp``, as phase 4's backward checks), the launches
    and the split's counters exact (all-reduces only: a gather or
    reduce-scatter on the fake group would leave its output unset), the
    loss and every updated block finite; then 3 steps timed, one
    profiled, its resident and peak memory.  Prints one RESULT_5V line; returns 0."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.common import build_kernels
    build_kernels()
    from repro_torch.checkpoint.store import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.hw import MeshDescriptor
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.bwd_kernel import (
        flash_attention_bwd_plain)
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_mesh_from_descriptor
    from repro_torch.models import init_params, transformer
    from repro_torch.optim import AdamW
    from repro_torch.parallel import make_plan
    from repro_torch.parallel.split import COUNTS as split_counts
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    peaks = PEAKS[torch.cuda.get_device_name(0)]
    t0 = time.perf_counter()
    dryrun.fake_world(SPLIT_WORLD)
    n = SPLIT_WORLD
    x = torch.ones(2 * n, device=device)
    dist.all_reduce(x)
    dist.all_gather([torch.empty_like(x) for _ in range(n)], x)
    dist.all_to_all_single(torch.empty_like(x), x)
    torch.cuda.synchronize()
    print(f"5v the fake backend ({dist.get_backend()}, {n} ranks) took "
          f"all_reduce, all_gather and all_to_all_single on CUDA tensors",
          flush=True)
    cfg = get_config(LM_ARCH)
    L = cfg.n_layers
    desc = MeshDescriptor((1, n), ("data", "model"))
    mesh = make_mesh_from_descriptor(desc, "cuda")
    init_s = time.perf_counter() - t0
    counters = lm_counters()
    gen = torch.Generator(device).manual_seed(SEED + 7)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                         generator=gen, device=device)
    dtoks = [torch.randint(0, cfg.vocab, (TRAIN_BATCH,), generator=gen,
                           device=device) for _ in range(SPLIT_DECODE)]
    names = ("flash_attention", "decode_attention", "flash_attention_bwd")
    errs = {k: 0.0 for k in names}
    seen = {k: Counter() for k in names}
    bwd_seen = {"worst": 0.0, "want": 0.0}
    first = {}

    def held(name, orig):
        """``orig`` (the kernel path on CUDA tensors), each call held
        against its plain version on the same inputs."""
        def call(*args, **kw):
            out = orig(*args, **kw)
            with torch.no_grad():
                want = orig(*args, **{**kw, "impl": "reference"})
                errs[name] = max(errs[name], max_err(out, want, BF16_TOL))
            seen[name][(tuple(args[0].shape), tuple(args[1].shape))] += 1
            first.setdefault(name, (args, kw))
            return out
        return call

    def held_bwd(orig):
        """The backward kernel's wrapper, each call's (dq, dk, dv) held
        against its plain version on the same inputs at one bf16 ulp plus
        the f32 rounding bound of its sums, as ``check_flash_bwd``: the
        gradients at this shape are near 1e-3, so an absolute 2^-7 would
        pass zeros.  Keeps the largest |want| and the largest error over
        its tolerance beside the largest error."""
        name = "flash_attention_bwd"

        def call(*args, **kw):
            got = orig(*args, **kw)
            with torch.no_grad():
                want = flash_attention_bwd_plain(*args, **kw)
                mags = bwd_magnitudes(*args, **kw)
            slack = bwd_slack(args[1].shape[2], args[0].shape[-1])
            for g, w, m in zip(got, want, mags):
                err, worst = max_err_ulp(g, w, slack * m)
                errs[name] = max(errs[name], err)
                bwd_seen["worst"] = max(bwd_seen["worst"], worst)
                bwd_seen["want"] = max(bwd_seen["want"],
                                       w.float().abs().max().item())
            seen[name][(tuple(args[0].shape), tuple(args[1].shape))] += 1
            first.setdefault(name, (args, kw))
            return got
        return call

    def synced(call):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    def peak_gb(call):
        """(GB allocated before ``call``, its peak GB above that)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        return (before / 1e9,
                (torch.cuda.max_memory_allocated() - before) / 1e9)

    launches = {k: 0 for k in counters}
    result = {"init_s": init_s, "strategies": {}}
    pshape = ShapeSpec("5v prefill", TRAIN_SEQ, TRAIN_BATCH, "prefill")
    dshape = ShapeSpec("5v decode", TRAIN_SEQ, TRAIN_BATCH, "decode")
    for strategy in ("tp", "auto"):
        pre = steps.build_step(cfg, pshape,
                               make_plan(cfg, pshape, desc, strategy), mesh)
        dec = steps.build_step(cfg, dshape,
                               make_plan(cfg, dshape, desc, strategy), mesh)
        full = init_params(transformer.param_defs(cfg),
                           torch.Generator(device).manual_seed(SEED))
        params = steps.distribute_tree(full, pre.specs["params"], mesh)
        dparams = steps.distribute_tree(full, dec.specs["params"], mesh)
        del full
        torch.cuda.empty_cache()
        # The main path: the counts set to 0 (read as a difference) just
        # before, read just after.
        split_counts.clear()
        before = {k: fn.launches for k, fn in counters.items()}
        saved = transformer.flash_attention, transformer.decode_attention
        transformer.flash_attention = held("flash_attention", saved[0])
        transformer.decode_attention = held("decode_attention", saved[1])
        try:
            logits, cache = pre.fn(params, {"tokens": toks})
            for t in dtoks:
                logits, cache = dec.fn(dparams, cache, {"tokens": t})
            torch.cuda.synchronize()
        finally:
            transformer.flash_attention, transformer.decode_attention = saved
        got = {k: fn.launches - before[k] for k, fn in counters.items()}
        counts = dict(split_counts)
        for k in launches:
            launches[k] += got[k]
        local = logits.to_local()
        if not torch.isfinite(local.float()).all():
            fail(f"5v {strategy}: rank 0's logits are not finite")
        want = {k: 0 for k in counters}
        want.update(flash_attention=L, decode_attention=L * SPLIT_DECODE)
        want_counts = {f"flash:whole:{SPLIT_HEADS[0]}/{SPLIT_HEADS[1]}": L,
                       f"decode:whole:{SPLIT_HEADS[0]}/{SPLIT_HEADS[1]}":
                       L * SPLIT_DECODE}
        if got != want or counts != want_counts:
            fail(f"5v {strategy}: launches {got}, split counters {counts}; "
                 f"want {want}, {want_counts}")
        _, pre_ms = synced(lambda: pre.fn(params, {"tokens": toks}))
        dec_ms = statistics.median(
            synced(lambda: dec.fn(dparams, cache, {"tokens": t}))[1]
            for t in dtoks)
        prof = {"prefill": profile_train(
                    f"5v prefill ({strategy}, rank 0 of {n})",
                    lambda: pre.fn(params, {"tokens": toks}), pre_ms),
                "decode": profile_train(
                    f"5v decode step ({strategy}, rank 0 of {n})",
                    lambda: dec.fn(dparams, cache, {"tokens": dtoks[0]}),
                    dec_ms)}
        result["strategies"][strategy] = {
            "prefill_ms": pre_ms, "decode_ms": dec_ms,
            "device_ms": {k: v and v["device_ms"] for k, v in prof.items()},
            "peak_gb": {
                "prefill": peak_gb(lambda: pre.fn(params, {"tokens": toks})),
                "decode": peak_gb(lambda: dec.fn(dparams, cache,
                                                 {"tokens": dtoks[0]}))},
            "logits_block": list(local.shape),
            "cache_block": list(cache["k"].to_local().shape),
            "launches": got, "counts": counts}
        print(f"5v {strategy}: launches {got}, split counters {counts}; "
              f"rank 0's logits block {list(local.shape)}, cache block "
              f"{list(cache['k'].to_local().shape)}; prefill {pre_ms:.2f} "
              f"ms, decode step {dec_ms:.2f} ms", flush=True)
        del params, dparams, cache, logits, pre, dec
    torch.cuda.empty_cache()

    # The train leg: 5t's batches, rank 0's blocks and f32 moments.
    tshape = ShapeSpec("5v train", TRAIN_SEQ, TRAIN_BATCH, "train")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in data.batch_at(i).items()}
               for i in range(SPLIT_TRAIN_STEPS)]
    heads = f"{SPLIT_HEADS[0]}/{SPLIT_HEADS[1]}"
    result["train"] = {}
    for strategy in ("tp", "auto"):
        plan = make_plan(cfg, tshape, desc, strategy)
        opt = AdamW()
        bundle = steps.build_step(cfg, tshape, plan, mesh, optimizer=opt)
        full = init_params(transformer.param_defs(cfg),
                           torch.Generator(device).manual_seed(SEED))
        params = steps.distribute_tree(full, bundle.specs["params"], mesh)
        state = steps.distribute_tree(opt.init(full),
                                      bundle.specs["opt_state"], mesh)
        del full
        torch.cuda.empty_cache()
        # The main path: the counts set to 0 (read as a difference) just
        # before, read just after.
        split_counts.clear()
        before = {k: fn.launches for k, fn in counters.items()}
        saved = transformer.flash_attention, flash_ops.flash_attention_bwd_cuda
        transformer.flash_attention = held("flash_attention", saved[0])
        flash_ops.flash_attention_bwd_cuda = held_bwd(saved[1])
        try:
            losses = [float(bundle.fn(params, state, b)[2]["loss"])
                      for b in batches]
            torch.cuda.synchronize()
        finally:
            transformer.flash_attention = saved[0]
            flash_ops.flash_attention_bwd_cuda = saved[1]
        got = {k: fn.launches - before[k] for k, fn in counters.items()}
        counts = dict(split_counts)
        for k in launches:
            launches[k] += got[k]
        # Per step, under remat: each layer's flash forward and its
        # recompute, one backward; wo's and w_down's all-reduces and wo's
        # again in the recompute (it stops before w_down's); the attention
        # and MLP inputs' "to model" all-reduces.  49152 is no multiple
        # of 5: the embedding and head stay whole, with no collective.
        n_t = SPLIT_TRAIN_STEPS
        want = {k: 0 for k in counters}
        want.update(flash_attention=2 * L * n_t,
                    flash_attention_bwd=L * n_t)
        want_counts = {f"flash:whole:{heads}": 2 * L * n_t,
                       "model_all_reduce:fwd": 3 * L * n_t,
                       "model_all_reduce:bwd": 2 * L * n_t}
        if got != want or counts != want_counts:
            fail(f"5v train {strategy}: launches {got}, split counters "
                 f"{counts}; want {want}, {want_counts}")
        finite = all(math.isfinite(x) for x in losses) and all(
            bool(torch.isfinite(getattr(t, "to_local", lambda: t)()
                                .float()).all())
            for t in tree_leaves((params, state)))
        if not finite:
            fail(f"5v train {strategy}: a loss or an updated block is not "
                 f"finite: losses {losses}")
        step_ms = [synced(lambda: bundle.fn(params, state, batches[0]))[1]
                   for _ in range(3)]
        ms = statistics.median(step_ms)
        prof = profile_train(f"5v train step ({strategy}, rank 0 of {n})",
                             lambda: bundle.fn(params, state, batches[0]),
                             ms)
        result["train"][strategy] = {
            "ms": step_ms, "losses": losses, "launches": got,
            "counts": counts, "device_ms": prof and prof["device_ms"],
            "busy": prof and prof["busy"],
            "groups": prof and prof["groups"],
            "gb": peak_gb(lambda: bundle.fn(params, state, batches[0])),
            "layout": plan.decisions.get("layout", strategy)}
        print(f"5v train {strategy} "
              f"({result['train'][strategy]['layout']}): losses "
              f"{[round(x, 4) for x in losses]}; launches {got}, split "
              f"counters {counts}; step ms {[round(t, 2) for t in step_ms]}"
              f"; GB before + peak above "
              f"{result['train'][strategy]['gb']}", flush=True)
        del params, state, bundle
        torch.cuda.empty_cache()
    for name, shapes in seen.items():
        tol = (f"max |want| {bwd_seen['want']:.3e}; at most "
               f"{bwd_seen['worst']:.3f} of its tolerance, one bf16 ulp + "
               f"the f32 bound" if name == "flash_attention_bwd"
               else f"tolerance {BF16_TOL}")
        print(f"5v {name} launch shapes (q, k) and calls: {dict(shapes)}; "
              f"max |err| against the plain version {errs[name]:.3e} "
              f"({tol})", flush=True)
    # One launch of each at the rank's shard shapes, timed (the first
    # call's inputs): kernel, plain version, SDPA, bound.
    rows = {}
    by = 2
    (q, k, v), kw = first["flash_attention"]
    B, H, S, D = q.shape
    KV = k.shape[1]
    scale = D ** -0.5
    flops = 4 * D * H * B * S * (S + 1) // 2
    nbytes = B * (by * D * (2 * H * S + 2 * KV * S) + 4 * H * S)
    rows["flash_attention"] = {
        "ms": time_ms(lambda: transformer.flash_attention(
            q, k, v, causal=True, impl="cuda")),
        "plain_ms": time_ms(lambda: transformer.flash_attention(
            q, k, v, causal=True, impl="reference")),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True)),
        "flop_ms": flops / peaks["bfloat16"] * 1e3,
        "byte_ms": nbytes / peaks["hbm"] * 1e3,
        "shape": [B, H, KV, S, D]}
    # The backward at the train leg's shard shape (its first call's
    # inputs), bound as in ``check_flash_bwd``: q, k, v, out, dO and lse
    # read once, dq, dk, dv written once; 5 products of 2 D FLOP per
    # unmasked pair.  library_ms: SDPA's forward + backward less its
    # forward.
    (q, k, v, out, lse, do), kw = first["flash_attention_bwd"]
    B, H, S, D = q.shape
    KV = k.shape[1]
    pairs = S * (S + 1) // 2
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sdpa = lambda: F.scaled_dot_product_attention(
        *leaves, is_causal=True, scale=kw["scale"], enable_gqa=True)
    sdpa_ms = time_ms(sdpa)
    rows["flash_attention_bwd"] = {
        "ms": time_ms(lambda: flash_ops.flash_attention_bwd_cuda(
            q, k, v, out, lse, do, **kw)),
        "plain_ms": time_ms(lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, do, **kw)),
        "library_ms": time_ms(
            lambda: torch.autograd.grad(sdpa(), leaves, do)) - sdpa_ms,
        "flop_ms": 5 * 2 * D * pairs * B * H / peaks["bfloat16"] * 1e3,
        "byte_ms": (by * (4 * B * H * S * D + 4 * B * KV * S * D)
                    + 4 * B * H * S) / peaks["hbm"] * 1e3,
        "shape": [B, H, KV, S, D]}
    del leaves
    (q, ck, cv), kw = first["decode_attention"]
    kv_len = kw["kv_len"]
    B, H, D = q.shape
    KV, S = ck.shape[1], ck.shape[2]
    live = int(kv_len.sum())
    mask = (torch.arange(S, device=device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    rows["decode_attention"] = {
        "ms": time_ms(lambda: transformer.decode_attention(
            q, ck, cv, kv_len=kv_len, impl="cuda")),
        "plain_ms": time_ms(lambda: transformer.decode_attention(
            q, ck, cv, kv_len=kv_len, impl="reference")),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], ck, cv, attn_mask=mask, scale=scale,
            enable_gqa=True)[:, :, 0]),
        "flop_ms": 4 * D * H * live / peaks["bfloat16"] * 1e3,
        "byte_ms": (by * (2 * q.numel() + 2 * KV * D * live) + 4 * B)
        / peaks["hbm"] * 1e3,
        "shape": [B, H, KV, S, D]}
    for name, r in rows.items():
        r["bound_ms"] = max(r["flop_ms"], r["byte_ms"])
        print(f"5v {name} at the shard shape {r['shape']} (B, H, KV, S, D),"
              f" bf16: ms {r['ms']:.4f}, plain_ms {r['plain_ms']:.4f}, "
              f"library_ms (SDPA) {r['library_ms']:.4f}, bound_ms "
              f"{r['bound_ms']:.4f} ("
              f"{'operations' if r['flop_ms'] >= r['byte_ms'] else 'bytes'})",
              flush=True)
    result.update(launches=launches, errs=errs, bwd_held=bwd_seen,
                  rows=rows,
                  shapes={k: [list(map(list, s)) for s in v]
                          for k, v in seen.items()})
    print("RESULT_5V:" + json.dumps(result), flush=True)
    dist.destroy_process_group()
    return 0


def split_phase(sharded) -> tuple[dict, dict]:
    """Phase 5v: ``split_child`` in a subprocess while nothing else runs;
    its output printed, rank 0's prefill and decode ms, device ms and
    peak memory beside 5t's weight-gathered ones (fsdp: the whole model
    on its world of one), and its train step's beside 5t's auto train
    step (the whole model at a group of one).
    Returns (launches, the child's result)."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke.split_child())"],
        cwd=str(ROOT), capture_output=True, text=True,
        timeout=SPLIT_TIMEOUT)
    print(run.stdout + run.stderr[-4000:], flush=True)
    line = [l for l in run.stdout.splitlines() if l.startswith("RESULT_5V:")]
    if run.returncode != 0 or not line:
        fail(f"5v: the split subprocess exited {run.returncode}")
    res = json.loads(line[0][len("RESULT_5V:"):])
    a = sharded["serving"]["fsdp"]
    dev5t = {k: (a["profiles"][k] or {}).get("device_ms")
             for k in ("prefill", "decode")}
    fmt = lambda v: "not measured" if v is None else f"{v:.2f}"
    gb = lambda v: f"{v[0]:.2f} + {v[1]:.3f}"
    for strategy, st in res["strategies"].items():
        print(f"5v {strategy} rank 0 of {SPLIT_WORLD} against 5t's world of "
              f"one (fsdp, weight-gathered): prefill 8 x {TRAIN_SEQ} "
              f"{st['prefill_ms']:.2f} / {a['prefill_ms']:.2f} ms, device "
              f"{fmt(st['device_ms']['prefill'])} / {fmt(dev5t['prefill'])}"
              f" ms, GB before + peak above {gb(st['peak_gb']['prefill'])} "
              f"/ {gb(a['peak_gb']['prefill'])}; decode step "
              f"{st['decode_ms']:.2f} / {a['decode_ms']:.2f} ms, device "
              f"{fmt(st['device_ms']['decode'])} / {fmt(dev5t['decode'])} "
              f"ms, GB {gb(st['peak_gb']['decode'])} / "
              f"{gb(a['peak_gb']['decode'])}", flush=True)
    t_ms = sharded["steps"]["auto"]["ms"][-1]
    t_prof = sharded["profiles"][0] or {}
    for strategy, st in res["train"].items():
        ms = statistics.median(st["ms"])
        dev = st["device_ms"]
        ratio = (f"{dev / t_prof['device_ms']:.3f}" if dev and
                 t_prof.get("device_ms") else "not measured")
        print(f"5v train {strategy} rank 0 of {SPLIT_WORLD} against 5t's "
              f"auto train step (world of one): step {ms:.2f} / "
              f"{t_ms:.2f} ms, device {fmt(dev)} / "
              f"{fmt(t_prof.get('device_ms'))} ms (ratio {ratio}; busy "
              f"{fmt(st['busy'] and 100 * st['busy'])}% / "
              f"{fmt(t_prof.get('busy') and 100 * t_prof['busy'])}%), GB "
              f"before + peak above {gb(st['gb'])} / "
              f"{gb(sharded['train_gb'])} (resident ratio "
              f"{st['gb'][0] / sharded['train_gb'][0]:.3f})", flush=True)
    took("5v", t0)
    return res["launches"], res


def lap(label: str) -> None:
    """Print the seconds since the script started, at the end of the
    phases ``label`` names: the script against its time limit."""
    print(f"[chip_smoke] {label}: {time.perf_counter() - START:.1f} s",
          flush=True)


def took(label: str, t0: float) -> None:
    """Print the seconds a part of a phase took since ``t0``: where the
    script's time goes inside a phase."""
    print(f"[chip_smoke] {label} took {time.perf_counter() - t0:.1f} s",
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.common import BUILD_LOGS, build_kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    if name not in PEAKS:
        fail(f"no data-sheet peaks for {name!r}; bound_ms needs them")
    peaks = PEAKS[name]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; peaks "
          f"f32 {peaks['float32'] / 1e12:.0f} TFLOP/s, bf16 "
          f"{peaks['bfloat16'] / 1e12:.0f} TFLOP/s, HBM "
          f"{peaks['hbm'] / 1e12:.2f} TB/s (data sheet)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    secs = build_kernels()
    print(f"built kernels in {time.perf_counter() - t0:.1f} s: {secs}")
    for lib, log in BUILD_LOGS.items():
        kernel = ""
        for line in log.splitlines():
            if "entry function" in line:
                kernel = kernel_name(line)
            elif "registers" in line or "spill" in line:
                print(f"  {lib} {kernel}: {line.strip()}")

    lap("built")
    rows = check_kernels(device, peaks)
    rows += check_bf16_convs(device)
    lm_rows, uses = check_lm_kernels(device, peaks)
    z_rows, z_uses = check_lm_kernels(device, peaks, "zamba2-7b")
    paged_rows = check_paged_kernel(device, peaks)
    ssm = check_ssm_kernels(device, peaks)
    bwd_row = check_flash_bwd(device, peaks)
    g_rows, g_uses = check_lm_kernels(device, peaks, MOE_ARCH)
    g_bwd_row = check_flash_bwd(device, peaks, MOE_ARCH)
    w_rows, w_uses = check_lm_kernels(device, peaks, WHISPER)
    v_rows = check_vlm_kernels(device, peaks)
    scan_train_err, scan_train_rows = check_train_scans(device, peaks)
    attn_fwd_err, attn_bwd_err, attn_train_rows = check_train_attention(
        device, peaks)
    lap("phases 3-4")
    cnn_launches, img_s, cnn_graphed = serve_alexnet(device)
    resnet18_forward(device)
    from repro_torch.core import SNOWFLAKE
    pf_launches, pf_img_s, pf_tick_ms, pf_graphed = serve_paper_faithful(
        device, img_s)
    n_strips = resnet18_forward(device, hw=SNOWFLAKE, paper_faithful=True)
    if n_strips != 20:
        fail(f"5i resnet18: {n_strips} strip launches, want 20")
    lap("5a, 5i")
    from repro_torch.launch import serve
    n_lm = int(LM_ARGS[LM_ARGS.index("--requests") + 1])
    lm_launches, lm_stats, lm_eng, _ = serve_lm(
        "5b", lambda: serve.main(LM_ARGS), n_lm)
    lm_stats["legacy"] = legacy_leg("5b", lm_eng, lm_stats, LM_ARCH)
    del lm_eng
    lap("5b")
    win_launches, win_stats, _, _ = serve_lm(
        "5b window", lambda: serve.main(LM_ARGS + ["--window",
                                                   str(LM_WINDOW)]), n_lm)
    lap("5b window")
    tune_launches, tune_errs = tune_phase(device)
    lap("5n")
    paged = {label: serve_paged(label)
             for label in ("5c paged", "5d int8", "5e chunked")}
    lap("5c-5e")
    smoke_launches = train_smoke(device)
    train_launches, train_stats = train_lm(device, bwd_row)
    lap("5f")
    family = {}
    for label, arch in (("5g zamba2-7b", "zamba2-7b"),
                        ("5h rwkv6-7b", "rwkv6-7b")):
        family[label] = serve_family(label, arch)
        lap(label[:2])
    moe_launches, moe_stats = serve_family(f"5j {MOE_ARCH}", MOE_ARCH)
    lap("5j")
    moe_train_launches, moe_train = train_moe(device, g_bwd_row)
    lap("5k")
    w_launches, w_stats = serve_whisper(f"5l {WHISPER}")
    lap("5l")
    spec_launches, spec_stats = serve_spec(lm_stats)
    lap("5m")
    vlm_launches, vlm_stats = serve_vlm(device)
    lap("5o")
    fam_train = {}
    for label, arch, depth in FAMILY_TRAIN:
        fam_train[label] = train_family(label, arch, device, depth)
        lap(label)
    sharded_launches, sharded = sharded_phase(device, train_stats)
    lap("5t")
    dryrun_phase(peaks, sharded)
    lap("5u")
    split_launches, split = split_phase(sharded)
    lap("5v")
    tick = {}
    for kname, label in (("conv2d_virtual", "alexnet-owt"),
                         ("matmul", "alexnet-owt"),
                         ("conv2d_strips", "alexnet-owt@snowflake"),
                         ("matmul@snowflake", "alexnet-owt@snowflake")):
        mine = [r for r in rows if r["kernel"] == kname.split("@")[0]
                and r["arch"] == label]
        keys = ("ms", "plain_ms", "library_ms", "bound_ms", "flop_ms",
                "byte_ms") + (("copy_ms",) if kname == "conv2d_strips"
                              else ())
        tick[kname] = {k: sum(r["uses"] * r[k] for r in mine) for k in keys}
        tick[kname]["launches"] = sum(r["uses"] for r in mine)
    ts, tm = tick["conv2d_strips"], tick["matmul@snowflake"]
    pf_sum = ts["ms"] + ts["copy_ms"] + tm["ms"]
    zc_sum = tick["conv2d_virtual"]["ms"] + tick["matmul"]["ms"]
    print(f"alexnet-owt ticks: zero-copy {served(cnn_graphed, 'run', zc_sum)}"
          f"; paper-faithful {served(pf_graphed, 'run', pf_sum)}; capture "
          f"{cnn_graphed['capture_s']:.3f} and {pf_graphed['capture_s']:.3f}"
          f" s")
    print(f"alexnet-owt SNOWFLAKE paper-faithful tick: served "
          f"{pf_tick_ms:.3f} ms against a device sum of "
          f"{pf_sum:.3f} ms (conv2d_strips "
          f"{ts['launches']} x = {ts['ms']:.4f} ms, bound "
          f"{ts['bound_ms']:.4f}, plain {ts['plain_ms']:.4f}, cuDNN "
          f"{ts['library_ms']:.4f}; strip copies {ts['copy_ms']:.4f} ms; "
          f"matmul {tm['launches']} x = {tm['ms']:.4f} ms); zero-copy "
          f"tick: conv2d_virtual {tick['conv2d_virtual']['ms']:.4f} ms")
    lm = {(p, kind, k): lm_sums(lm_rows, uses, p, kind, k)
          for p in ("full", "window") for kind in ("prefill", "decode")
          for k in ("flash_attention", "decode_attention", "matmul")}
    for p, stats in (("full", lm_stats), ("window", win_stats)):
        for kind in ("prefill", "decode"):
            ks = [lm[(p, kind, k)] for k in ("flash_attention",
                                             "decode_attention", "matmul")]
            ksum = sum(x["ms"] for x in ks)
            print(f"smollm-360m {p} {kind}: {served(stats, kind, ksum)} "
                  f"per call against a kernel sum of "
                  f"{ksum:.3f} ms (bound "
                  f"{sum(x['bound_ms'] for x in ks):.4f} ms; "
                  + ", ".join(f"{k} {x['launches']} x = {x['ms']:.3f} ms"
                              for k, x in zip(("flash", "decode", "matmul"),
                                              ks)) + ")")
    # The paged kernel per smollm-360m decode tick: one launch per layer
    # at phase 4's lengths, bf16 pools (the served type).
    n_layers = lm[("full", "decode", "decode_attention")]["launches"]
    paged_tick = {k: n_layers * paged_rows["bfloat16"][k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "flop_ms", "byte_ms")}
    paged_tick["launches"] = n_layers
    for label, (_, stats) in paged.items():
        print(f"smollm-360m {label}: decode tick {served(stats, 'decode')}"
              + "".join(f"; {k} {served(stats, k)}" for k in (
                  "prefill", "chunk") if stats[f"{k}_ms"])
              + f"; capture {stats['capture_s']:.3f} s")
        print(f"smollm-360m {label}: {stats['tok_s']:.1f} tok/s, decode tick "
              f"{stats['tick_ms']:.3f} ms mean, prefill "
              f"{stats['prefill_ms'] or 0:.3f} ms, chunk "
              f"{stats['chunk_ms'] or 0:.3f} ms per call; paged kernel "
              f"{n_layers} x {paged_rows['bfloat16']['ms']:.4f} ms per tick "
              f"at phase 4's lengths (int8 pools "
              f"{paged_rows['int8']['ms']:.4f} ms)")
    print(f"alexnet-owt tick: matmul {tick['matmul']['ms']:.4f} ms "
          f"(3 launches)")
    # zamba2-7b per admission and per tick: the phase-4 rows of its
    # flash, decode and matmul ops and the scan at the served shapes.
    scan = ssm["mamba2_scan"]["rows"]
    n_scan = PAIR_OPS["zamba2-7b"][0]["ssm_scan"]
    n_wkv = PAIR_OPS["rwkv6-7b"][0]["wkv"]
    z = {}
    for kind, key in (("prefill", "admission"), ("decode", "tick")):
        parts = {k: lm_sums(z_rows, z_uses, "full", kind, k) for k in (
            "flash_attention", "decode_attention", "matmul")}
        parts["mamba2_scan"] = {k: n_scan * scan[key][k] for k in (
            "ms", "plain_ms", "bound_ms", "flop_ms", "byte_ms")}
        parts["mamba2_scan"]["launches"] = n_scan
        z[kind] = parts
        ksum = sum(x["ms"] for x in parts.values())
        print(f"zamba2-7b {kind}: "
              f"{served(family['5g zamba2-7b'][1], kind, ksum)} per call "
              f"against a kernel sum of {ksum:.3f} "
              f"ms (bound {sum(x['bound_ms'] for x in parts.values()):.4f} "
              f"ms; " + ", ".join(
                  f"{k} {x['launches']} x = {x['ms']:.3f} ms"
                  for k, x in parts.items()) + "); cuBLAS in_proj / "
              "out_proj and the plain torch around them not timed per op")
    # The matmul kernel per Program run: the bf16 phase-4 rows summed over
    # smollm-360m's and zamba2-7b's admissions (M = 512, wgmma) and
    # decode ticks (M = 8, skinny), and the f32 phase-3 rows over one
    # alexnet-owt batch-8 tick (skinny).
    for what, t in (
            ("smollm-360m decode tick, bf16",
             lm[("full", "decode", "matmul")]),
            ("smollm-360m admission, bf16", lm[("full", "prefill", "matmul")]),
            ("zamba2-7b admission, bf16", z["prefill"]["matmul"]),
            ("zamba2-7b decode tick, bf16", z["decode"]["matmul"]),
            ("alexnet-owt tick, f32", tick["matmul"])):
        print(f"matmul per {what}: {t['launches']} launches, ms "
              f"{t['ms']:.4f}, library_ms {t['library_ms']:.4f}, bound_ms "
              f"{t['bound_ms']:.4f}, plain_ms {t['plain_ms']:.4f}")
    wkv = ssm["wkv6"]["rows"]["admission"]
    h = family["5h rwkv6-7b"][1]
    print(f"rwkv6-7b admission: {served(h, 'prefill', n_wkv * wkv['ms'])};"
          f" decode tick {served(h, 'decode')}; capture {h['capture_s']:.3f}"
          f" s (zamba2-7b {family['5g zamba2-7b'][1]['capture_s']:.3f} s)")
    print(f"rwkv6-7b admission: served "
          f"{family['5h rwkv6-7b'][1]['prefill_ms']:.3f} ms, wkv6 {n_wkv} x "
          f"{wkv['ms']:.4f} = {n_wkv * wkv['ms']:.3f} ms (plain "
          f"{n_wkv * wkv['plain_ms']:.3f}, bound "
          f"{n_wkv * wkv['bound_ms']:.4f}); "
          f"decode tick {family['5h rwkv6-7b'][1]['tick_ms']:.3f} ms")

    # granite-moe-1b-a400m per admission and per tick: phase 4's rows of
    # its flash, decode and matmul ops; its expert dispatch is plain torch
    # (the reference's einsums), not in the sum.
    gm = {}
    for kind in ("prefill", "decode"):
        parts = {k: lm_sums(g_rows, g_uses, "full", kind, k) for k in (
            "flash_attention", "decode_attention", "matmul")}
        gm[kind] = parts
        ksum = sum(x["ms"] for x in parts.values())
        print(f"{MOE_ARCH} {kind}: {served(moe_stats, kind, ksum)} per call "
              f"against a kernel sum of {ksum:.3f} ms (bound "
              f"{sum(x['bound_ms'] for x in parts.values()):.4f} ms; "
              + ", ".join(f"{k} {x['launches']} x = {x['ms']:.3f} ms "
                          f"(plain {x['plain_ms']:.3f}, library "
                          f"{x['library_ms']:.3f}, bound {x['bound_ms']:.4f})"
                          for k, x in parts.items())
              + "); the expert dispatch, plain torch, not in the sum")
    for desc, row in sorted(g_rows.items()):
        if row["kernel"] == "matmul":
            print(f"{MOE_ARCH} matmul/{row['path']}: ms {row['ms']:.4f}, "
                  f"bound_ms {row['bound_ms']:.4f}, plain_ms "
                  f"{row['plain_ms']:.4f}, library_ms (torch.addmm) "
                  f"{row['library_ms']:.4f} | {desc}")
    # whisper-base per admission (the encoder, then the prefill Program)
    # and per tick: phase 4's rows of its flash, decode and matmul ops.
    for kind in ("encoder", "prefill", "decode"):
        parts = {k: lm_sums(w_rows, w_uses, "full", kind, k) for k in (
            "flash_attention", "decode_attention", "matmul")}
        parts = {k: x for k, x in parts.items() if x["launches"]}
        ksum = sum(x["ms"] for x in parts.values())
        if kind == "encoder":
            head = (f"{WHISPER} encoder: served {w_stats['encoder_median_ms']:.3f}"
                    f" ms per admission (median, eager: the projections "
                    f"are cuBLAS and the glue plain torch)")
        else:
            head = f"{WHISPER} {kind}: {served(w_stats, kind, ksum)} per call"
        print(f"{head} against a kernel sum of {ksum:.3f} ms (bound "
              f"{sum(x['bound_ms'] for x in parts.values()):.4f} ms; "
              + ", ".join(f"{k} {x['launches']} x = {x['ms']:.3f} ms "
                          f"(plain {x['plain_ms']:.3f}, library "
                          f"{x['library_ms']:.3f}, bound {x['bound_ms']:.4f})"
                          for k, x in parts.items()) + ")")
    for desc, row in sorted(w_rows.items()):
        if "b_transposed" in desc or "cross" in desc or "encoder" in desc:
            print(f"{WHISPER} {row['kernel']}"
                  + (f"/{row['path']}" if "path" in row else "")
                  + f": ms {row['ms']:.4f}, bound_ms {row['bound_ms']:.4f}, "
                  f"plain_ms {row['plain_ms']:.4f}, library_ms "
                  f"{row['library_ms']:.4f}"
                  + (" (torch.addmm with the embed.T view)"
                     if "b_transposed" in desc else " (SDPA)")
                  + f" | {desc}")
    L_moe = moe_train_launches["flash_attention_bwd"] // MOE_STEPS
    print(f"{MOE_ARCH} training step: flash forward {2 * L_moe} x "
          f"{g_bwd_row['fwd_ms']:.4f} = {2 * L_moe * g_bwd_row['fwd_ms']:.3f}"
          f" ms (plain {2 * L_moe * g_bwd_row['fwd_plain_ms']:.3f}, SDPA "
          f"{2 * L_moe * g_bwd_row['fwd_library_ms']:.3f}, bound "
          f"{2 * L_moe * g_bwd_row['fwd_bound_ms']:.4f}); backward {L_moe} x "
          f"{g_bwd_row['ms']:.4f} = {L_moe * g_bwd_row['ms']:.3f} ms (plain "
          f"{L_moe * g_bwd_row['plain_ms']:.3f}, SDPA "
          f"{L_moe * g_bwd_row['library_ms']:.3f}, bound "
          f"{L_moe * g_bwd_row['bound_ms']:.4f}); step graphed "
          f"{moe_train['graphed_ms']:.2f} / eager {moe_train['eager_ms']:.2f}"
          f" ms; smollm-360m step graphed {train_stats['graphed_ms']:.2f} / "
          f"eager {train_stats['eager_ms']:.2f} ms")
    per_path = [cnn_launches, pf_launches, lm_launches, win_launches,
                smoke_launches, train_launches, moe_launches,
                moe_train_launches, w_launches, spec_launches,
                tune_launches, vlm_launches] + [
        launch for launch, _ in fam_train.values()] + [
        sharded_launches, split_launches] + [
        launch for launch, _ in list(paged.values()) + list(family.values())
    ] + [st["legacy"]["launches"] for st in (
        lm_stats, w_stats, *(st for _, st in family.values()))]
    launches = {k: sum(p.get(k, 0) for p in per_path) for k in SOURCES}
    errs = {k: max([r["max_abs_err"] for r in rows if r["kernel"] == k]
                   + [r["max_abs_err"] for r in lm_rows.values()
                      if r["kernel"] == k]
                   + ([r["max_abs_err"] for r in paged_rows.values()]
                      if k == "paged_decode_attention" else [])
                   + ([bwd_row["max_abs_err"], g_bwd_row["max_abs_err"],
                       attn_bwd_err] if k == "flash_attention_bwd" else [])
                   + ([attn_fwd_err] if k == "flash_attention" else [])
                   + ([split["errs"][k]] if k in split["errs"] else [])
                   + ([scan_train_err] if k in ("mamba2_scan", "wkv6")
                      else [])
                   + [r["max_abs_err"] for r in g_rows.values()
                      if r["kernel"] == k]
                   + [r["max_abs_err"] for r in w_rows.values()
                      if r["kernel"] == k]
                   + [r["max_abs_err"] for r in v_rows.values()
                      if r["kernel"] == k]
                   + [r["max_abs_err"] for r in z_rows.values()
                      if r["kernel"] == k]
                   + ([ssm[k]["max_abs_err"]] if k in ssm else [])
                   + ([tune_errs[k]] if k in tune_errs else [])
                   + ([sharded["ring_err"]] if k == "matmul" else []))
            for k in SOURCES}
    # The backward kernel per smollm-360m training step: one launch per
    # layer at the training shape, bf16.
    n_bwd = train_launches["flash_attention_bwd"] // TRAIN_STEPS
    train_step = {k: n_bwd * bwd_row[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "flop_ms", "byte_ms")}
    train_step["launches"] = n_bwd
    # The flash kernels per Program run, from the bf16 phase-4 rows: the
    # forward per smollm-360m and zamba2-7b admission and per training
    # step (at batch 8 x 512, 2 launches a layer under remat), the
    # backward per training step.
    n_fwd = train_launches["flash_attention"] // TRAIN_STEPS
    fwd_step = {k: n_fwd * bwd_row["fwd_" + k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms")}
    fwd_step["launches"] = n_fwd
    for what, t in (
            ("forward per smollm-360m admission",
             lm[("full", "prefill", "flash_attention")]),
            ("forward per zamba2-7b admission",
             z["prefill"]["flash_attention"]),
            ("forward per smollm-360m training step", fwd_step),
            ("backward per smollm-360m training step", train_step)):
        print(f"flash {what}, bf16: {t['launches']} launches, ms "
              f"{t['ms']:.4f}, library_ms {t['library_ms']:.4f}, bound_ms "
              f"{t['bound_ms']:.4f}, plain_ms {t['plain_ms']:.4f}")
    # The kernels per training step of 5p-5s, from phase 4's training
    # rows: (kernel, attention or scan row, launches a step).
    for label, arch, _ in FAMILY_TRAIN:
        st = fam_train[label][1]
        ps = st["per_step"]
        parts = []
        if ps["mamba2_scan"]:
            parts.append(("mamba2_scan", scan_train_rows[arch], "ms",
                          ps["mamba2_scan"]))
        if ps["wkv6"]:
            parts.append(("wkv6", scan_train_rows[arch], "ms", ps["wkv6"]))
        for name, calls_f, calls_b in FAMILY_ATTN.get(arch, ()):
            row = attn_train_rows[name]
            twice = ps["flash_attention"] > ps["flash_attention_bwd"] \
                and name not in ("whisper encoder", "vlm cross")
            parts.append((f"flash forward ({name})", row, "fwd_ms",
                          (2 if twice else 1) * calls_f))
            parts.append((f"flash backward ({name})", row, "ms", calls_b))
        ksum = sum(n * row[key] for _, row, key, n in parts)
        bsum = sum(n * row["fwd_bound_ms" if key == "fwd_ms"
                           else "bound_ms"] for _, row, key, n in parts)
        print(f"{label} {arch} training step: graphed {st['graphed_ms']:.2f}"
              f" / eager {st['eager_ms']:.2f} ms; kernels "
              f"{ksum:.3f} ms a step (bound {bsum:.4f}): " + ", ".join(
                  f"{name} {n} x {row[key]:.4f}" for name, row, key, n
                  in parts) + "; the scans' plain recompute backward and "
              "the cuBLAS products not in the sum")
    print("5t sharded smollm-360m train step (world of one, NCCL), ms: "
          + "; ".join(f"{st} ({v['layout']}) {v['ms'][-1]:.2f} (first "
                      f"{v['ms'][0]:.2f}), eager single-device "
                      f"{v['eager_ms'][-1]:.2f}"
                      for st, v in sharded["steps"].items())
          + f"; 5f's step graphed {sharded['graphed_5f_ms']:.2f} / eager "
          f"{sharded['eager_5f_ms']:.2f}; prefill 8 x {TRAIN_SEQ} "
          f"{sharded['prefill_ms']:.2f} (legacy "
          f"{sharded['legacy_prefill_ms']:.2f}); decode step "
          f"{sharded['decode_ms']:.2f} (legacy "
          f"{sharded['legacy_decode_ms']:.2f}); NCCL init "
          f"{sharded['init_s']:.3f} s")
    per = {"conv2d_virtual": ("alexnet-owt batch-8 tick",
                              tick["conv2d_virtual"]),
           "conv2d_strips": (
               "SNOWFLAKE paper-faithful alexnet-owt batch-8 tick (5 "
               "launches; the strip copies' own device time, "
               f"{ts['copy_ms']:.4f} ms, is not in ms)", ts),
           "flash_attention": ("smollm-360m admission (prefill)",
                               lm[("full", "prefill", "flash_attention")]),
           "decode_attention": ("smollm-360m decode tick",
                                lm[("full", "decode", "decode_attention")]),
           "paged_decode_attention": (
               "smollm-360m paged decode tick, bf16 pools; library_ms is "
               "SDPA over the already-gathered view", paged_tick),
           "matmul": ("smollm-360m decode tick",
                      lm[("full", "decode", "matmul")]),
           "flash_attention_bwd": (
               f"smollm-360m training step ({n_bwd} launches at batch "
               f"{TRAIN_BATCH}, seq {TRAIN_SEQ}, bf16); library_ms is SDPA's "
               f"backward (forward + backward minus forward)", train_step),
           "mamba2_scan": (
               "zamba2-7b admission (81 launches at (1, 512, 112, 64), "
               "N = 64, bf16); no PyTorch call computes the scan, so "
               "library_ms is null", z["prefill"]["mamba2_scan"]),
           "wkv6": (
               "rwkv6-7b admission (32 launches at (1, 512, 64, 64), "
               "bf16); no PyTorch call computes the recurrence, so "
               "library_ms is null",
               {k: n_wkv * wkv[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "flop_ms", "byte_ms")})}
    kernels = []
    for kname in ("conv2d_virtual", "conv2d_strips", "matmul",
                  "flash_attention",
                  "decode_attention", "paged_decode_attention",
                  "flash_attention_bwd", "mamba2_scan", "wkv6"):
        what, t = per[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("operations" if t["flop_ms"] >= t["byte_ms"]
                         else "bytes"),
            "library_ms": t.get("library_ms")})
        print(f"kernels line: {kname} times per {what}")
        if launches[kname] == 0:
            fail(f"{kname} was never launched on the main paths")
    print(f"alexnet-owt serving: {img_s:.1f} img/s at {SLOTS} slots, "
          f"SNOWFLAKE paper-faithful {pf_img_s:.1f} img/s; "
          f"smollm-360m serving: {lm_stats['tok_s']:.1f} tok/s, window "
          f"{LM_WINDOW}: {win_stats['tok_s']:.1f} tok/s; "
          + ", ".join(f"{label}: {stats['tok_s']:.1f} tok/s"
                      for label, (_, stats) in paged.items())
          + f"; smollm-360m training: {train_stats['tok_s']:.0f} tokens/s, "
          f"step {train_stats['step_ms']:.1f} ms; "
          + ", ".join(f"{label}: {stats['tok_s']:.1f} tok/s"
                      for label, (_, stats) in family.items())
          + f"; {MOE_ARCH}: {moe_stats['tok_s']:.1f} tok/s served, "
          f"{moe_train['tok_s']:.0f} tokens/s trained (step "
          f"{moe_train['step_ms']:.1f} ms); {WHISPER}: "
          f"{w_stats['tok_s']:.1f} tok/s served; 5m speculative: "
          + ", ".join(f"{name} {st['tok_s']:.1f} tok/s"
                      for name, st in spec_stats.items()
                      if name in SPEC_RUNS)
          + "; " + ", ".join(
              f"{label} {arch}: {fam_train[label][1]['tok_s']:.0f} tokens/s "
              f"trained (step {fam_train[label][1]['graphed_ms']:.1f} ms)"
              for label, arch, _ in FAMILY_TRAIN)
          + f"; 5o {VLM_ARCH}: {vlm_stats['tok_s']:.1f} tok/s on the "
          f"legacy loop, decode step {vlm_stats['step_ms']:.2f} ms median "
          f"/ {vlm_stats['step_mean_ms']:.2f} mean; legacy legs (forward, "
          f"step ms): " + ", ".join(
              f"{name} {st['legacy']['forward_ms']:.1f} / "
              f"{st['legacy']['step_ms']:.1f}" for name, st in (
                  ("5b", lm_stats), ("5l", w_stats),
                  *((lab[:2], st) for lab, (_, st) in family.items()))))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
