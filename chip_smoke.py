#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only; imports nothing of jax or of the
JAX package.  Every phase prints one JSON line; any failure raises and the
script exits non-zero.  Phases:

  1. device   the card's name, capability (must be 9.0), its name and power
              limit from nvidia-smi; then the kernels are built from the
              sources in this checkout (build seconds, ptxas report).
  2. check    the fused-GEMM kernel against its plain PyTorch version on the
              card: the MATMUL_CASES grid of tests/test_grad_conformance.py
              (every plan of both regimes, gemm.PLANS) and the 12 DARKNET19
              GEMM shapes at batch 1
              and 8, all five activations, with and without scale/shift,
              fp32 and bf16 operands and outputs.  Max-relative error
              <= 1e-5 when everything is fp32, <= 5e-2 with bf16.
  3. network  DARKNET19_CFG at 224x224, full width, seeded init with
              randomized BN statistics: the `cuda` engine against the
              `eager` engine on the card (pre-softmax logits <= 1e-4
              max-relative, probabilities <= 1e-3), the built op plan, and
              exactly 12 kernel launches per forward.
  4. serve    the main path: a CNNServingEngine over compile_cache(buckets=
              (1, 2, 4, 8)) answers the ragged bursts (1, 3, 8, 2, 9, 4, 1,
              5) of examples/serve_cnn.py, 33 requests, with the launch count
              set to 0 just before and read just after.  Every request
              completes, builds equal compiled buckets, padded-bucket rows
              are bitwise equal to an exact-batch run; images/s and latency.
  5. timing   per DARKNET19 GEMM shape at batch 8: the kernel's median time
              (CUDA events), the plain version's, torch.matmul's (cuBLAS
              fp32, TF32 off, no epilogue: `library_ms`) and the bound.
  6. check_bwd  the training kernels against their plain versions on the
              card: the residual forward (y, g = act'(u), racc) over all five
              activations with and without scale and shift, its y bitwise
              equal to the serving launch's; dX and dW (every backward plan,
              gemm.BWD_PLANS, with and without a split contraction; the
              residual forward under every plan) on MATMUL_CASES and the 12
              DARKNET19 GEMMs at batch 8 in their dX and dW roles, fp32 and
              bf16.  Bars as phase 2; g of relu/leaky is compared away from
              the kink (|u| > 1e-5 max|u|), where two summation orders may
              put u on either side of 0.  Prints each dW's split count.
              At the same shapes (check_bwd_bits), fp32 and bf16: every
              backward plan gives the path plan's bits at the path's split
              for dX (W row-major and a tied head's E^T read in place) and
              both dW orientations (X^T dY and the tied head's dE = dY^T
              X); dX in one piece equals gemm_fused_fwd(dY, W^T) bit for
              bit.
  7. train    the training main path: full-width DARKNET19_CFG at batch 8,
              three AdamW steps (lr 1e-3, warmup 1) on the `cuda` engine and
              on the `eager` engine from the same state and numpy-seeded
              images.  Step-1 loss <= 1e-5 relative and every step-1
              gradient <= 1e-4 max-relative.  After that, AdamW's division
              by sqrt(nu) carries the rounding of near-zero gradient
              elements into the update undamped, so the trajectories drift
              apart by more than rounding: the losses of steps 2-3 and the
              parameters and moments after step 3 are held to 1e-5 / 1e-4
              or to FLOOR_FACTOR times the drift between two correct fp32
              programs, `eager` on the card and `eager` on the host CPU,
              whichever is larger.  Exactly 12 residual forwards, 11 dX,
              12 dW and the planned reduce passes per step, and no serving
              launch; per step the forward launches by regime (the 11
              convolutions in B, the 8-row head in A).
  8. timing_train  per backward GEMM of the path at batch 8 and per residual
              forward: kernel, plain, bound and library (torch.matmul) ms;
              the whole train step's ms and images/s on `cuda` and `eager`
              at batch 8 and 64.
  9. check_attn  the flash-attention forward kernel against its plain
              version: head ratios (16,16), (14,2), (8,1), Sq 1/4/16 against
              Skv 64/256, causal on and off, kv_len none / per batch with a 0,
              head dims 32/64/80/112/128/192 (80 and 112: the two plans
              `plans_at` admits; the 32-lane plan must refuse both by name
              with no launch, the decode kernel 80; 192:
              the 32-lane plan alone; 112 and 192 each draw from a
              generator of their own and report their errors apart), fp32
              and bf16; then
              qwen2-0.5b's shapes
              (prefill chunks at batch 1 and 4, a 512-token prompt, the
              training shape, shallow decode).  Rows with no live key must
              be exactly 0.  Bars as phase 2.  At every case every forward
              plan (flash_attention.PLANS), with and without lse, gives the
              path plan's bits, and the lse launch's o the serving
              launch's.
 10. check_decode  the split-KV decode kernel's partials and empty-span
              sentinels against its plain version over Sq 1/4/8 against
              Skv 256/1024 (head dims 32/64/112/128) and qwen2-0.5b's
              decode shapes; the launch that
              also merges gives the partials-only launch's partials and
              `combine`'s output (transposed and cast) bit for bit; at one
              split its partial must equal the forward kernel's output bit
              for bit.
 11. check_lm_gemm  the fused GEMM against its plain version at qwen2-0.5b's
              GEMMs (q, k, v with the bias as shift, o, the gate with silu,
              up, down, the tied head reading the (V, D) embedding layout
              transposed in place) at M 1, 8 and 64 with the path's plan,
              every epilogue and dtype as phase 2; the transposed head must
              give the bits of a row-major copy.
 12. timing_lm_gemm  each of those GEMMs in fp32 with its epilogue:
              kernel, plain, torch.matmul and bound ms (CUDA-graph
              replays over 24 distinct weights, one per layer, so they
              come from device memory as on the path), summed per
              dispatch (24 layers x 7 + the head) at each M; each row
              names its plan.
 13. lm       full-width, full-depth qwen2-0.5b (random weights from a seed,
              random QKV biases), `cuda` against `eager` on the card:
              prefill logits and caches at S = 512 and one decode dispatch
              against a 1024-row cache, within 1e-4 max-relative; the tied
              head is the embedding table's storage, read in place, and a
              decode dispatch allocates less than its size (it is never
              copied); a sequence's decode logits are bitwise equal in batch
              bucket 1 and 8.
 14. lm_serve the LM main path: a PagedServingEngine on `cuda` (chunk 64,
              prefill budget 256, buckets 1/2/4/8, 256 blocks of 16,
              max_len 1024) serves 24 requests (prompts 8-700 tokens,
              max_new 4-48, numpy seed), with the launch counts set to 0
              just before and read just after: every request completes,
              builds stay within the bound, both attention kernels ran, every
              GEMM launch was regime A's (no dispatch holds more than 64
              rows) and no `eager` op was dispatched.  Then the slot engine on a
              smaller stream: a token that differs from the paged engine's
              is allowed only where the `eager` top-2 margin is below 10 x
              the measured logits error (counted and printed).
 15. timing_lm  each attention kernel at the path's shapes: kernel, plain,
              bound and torch's scaled_dot_product_attention (TF32 off, a
              baseline only) ms, each the device time of CUDA-graph replays
              (`graph_ms`), and the kernel's time when called back to back
              from Python (`enqueued_ms`, host enqueue included); for the
              decode kernel (its launch with the merge) also the
              partials-only launch's and `combine`'s ms, and `op_ms`, the
              whole function SDPA computes; for the forward the plan
              `plan_for` picks and every plan's ms; the paged step's
              prefill-chunk and decode dispatch ms, tokens/s, p50 and p99.
 16. check_attn_bwd  the lse forward and the dQ and dK / dV kernels against
              their plain versions: head ratios (16,16), (14,2), (8,1), head
              dims 32/64/128, fp32 and bf16, (Sq, Skv) 64/64, 100/100,
              40/130, causal on and off, kv_len none / per batch with a 0;
              then qwen2-0.5b's training shape (batch 8, 512 positions, 14 /
              2 heads of 64).  Bars as phase 2; the lse launch keeps the
              serving launch's o bitwise; rows and keys with no live pair
              get exactly 0; two runs of each kernel give the same bits;
              at every case dQ under every plan (flash_attention.BWD_PLANS:
              16- and 64-row blocks, so two grids in two orders) gives the
              bits of the path's plan (bwd_plan_for).
 17. lm_train the LM training main path: full-width, full-depth qwen2-0.5b
              through launch.train.train_loop (batch 8 x 512, ce_chunk 512,
              remat, 3 AdamW steps, lr 3e-4, warmup 1, SyntheticLM seed 0)
              on `cuda`, with the launch counts set to 0 just before and
              read just after (exact counts per step, every GEMM and
              attention through the kernels, every forward GEMM in regime
              B, no `eager` op), then on `eager`
              and on `ref` from the same seeded parameters.  Step 1 (loss
              and gradients of loss_fn, cuda vs eager): loss <= 1e-5
              relative, every gradient <= 1e-4, two cuda runs bitwise equal
              (the embedding's scatter-add included).  Later steps and the
              parameters and moments after step 3: <= 1e-5 / 1e-4 or
              FLOOR_FACTOR times the drift between two correct fp32
              programs, `ref` against `eager` on the card (a host run of
              the full-width model would take minutes), whichever is
              larger.  The tied head is read in place: a head GEMM's
              forward and backward under grad allocate less than a copy of
              the embedding table beyond their outputs.
 18. lm_train_restart  reduced qwen2-0.5b on `cuda`: 4 steps straight vs a
              crash at step 3 and a restart from the step-2 checkpoint
              (under build/): the same losses and bit-identical parameters
              and moments.
 19. timing_lm_train  the train step's median ms, tokens/s and peak GB on
              `cuda` and `eager`; the device time by kernel name of one
              `cuda` step (torch.profiler); the lse forward and the dQ and
              dK / dV kernels at the training shape: kernel, plain, bound
              (14 D FLOPs per live pair and head, 4 D / 6 D / 8 D for the
              three kernels, at the FFMA rate) and library ms (SDPA, TF32
              off: its forward with enable_gqa, and its autograd backward,
              which computes dQ, dK and dV at once: compare `op_ms`, Delta
              plus both kernels; the faster of the boolean mask with
              enable_gqa and is_causal on K / V repeated to the H heads,
              the repeat and the group sum of dK / dV timed with it, both
              kept); dQ under every plan; each GEMM of the step at
              M = 4096 checked against its plain version (the head reading
              the embedding transposed, its dX bitwise a row-major copy's)
              and timed as kernel, plain, torch.matmul and bound ms, summed
              per step.
 20. check_ssd  the SSD chunk-scan kernel against its plain version: the
              SSD_GRID cases (S a multiple of the chunk and ragged, G 1 / 2,
              P 32 / 64, N 16 / 128, chunk 64 / 256, batch 1 / 4), the
              prefill shape of mamba2-1.3b (4 x 1000, 64 heads of 64, N 128,
              chunk 256) and every shape ssm_serve gives it (batch 1, S =
              each prompt less its last token), fp32 and bf16, with and
              without an initial state: y and the final state within the
              bars of phase 2, two runs bitwise equal, every plan
              (ssd.PLANS) bitwise the path plan's.
 21. ssm      full-width, full-depth mamba2-1.3b (random weights from a
              seed, dt bias, A and D moved off their init), `cuda` against
              `eager` on the card: the prefill of 4 x 1000 tokens (logits
              and every layer's conv tails and state within 1e-4
              max-relative, one SSD launch per layer), then 16 decode steps
              from those caches, both fed the same tokens, logits within
              1e-4 at every step.
 22. ssm_serve  the SSM main path: the slot ServingEngine on `cuda`, 4
              slots, 8 requests (prompts 8-48 tokens, max_new 4-16, numpy
              seed), with the launch counts set to 0 just before and read
              just after: every request completes, every prompt is
              prefilled through the SSD kernel (one launch per layer), every
              GEMM in regime A, no `eager` op; each request served in a reused slot gives the
              stream it gets alone on a fresh engine; every stream equals
              the slot engine's on `eager` on the card, or differs first
              where eager's top-2 logit margin is below 10 x phase 21's
              max-abs logit difference (a near tie).
 23. timing_ssm  prefill ms (S 1000) and decode ms per token at batch 1
              and 4 on `cuda` and `eager`; the device time by kernel name
              of one `cuda` prefill and of one `cuda` decode step at batch 4
              (torch.profiler) and their GEMM launches by regime (the
              prefill's projections B, its last-position head and every
              decode GEMM A) and plans; the SSD kernel at the prefill shape, at 4 x
              2048 and at each ssm_serve shape (device time from a CUDA
              graph; the kernels line takes the mean over ssm_serve's
              requests): kernel, plain and bound ms (the causal pairs times
              N once per group for C·Bᵀ, times P per head, and the state
              terms per head, at the FFMA rate; no single PyTorch call
              computes SSD, so no library time).
 24. lm_mixed (run after phases 15 and 23) full-width qwen2-0.5b and
              mamba2-1.3b prefill of 2 x 256 tokens under the `mixed` policy
              (bf16 operands and activations, fp32 accumulation) on `cuda`,
              `eager` and `ref`, and on `eager` in fp32: `cuda` vs `eager`
              within 5e-2 max-relative (the bf16 bar) or 1.5 x the drift
              between `ref` and `eager` (two mixed programs of plain
              PyTorch), whichever is larger, and `cuda`'s distance from
              the fp32 logits within 5e-2 or 1.5 x `eager`'s.
 25. check_bmm  the batched forward, dX and dW kernels of the engine `bmm`
              op against their plain versions: BMM_CASES of
              tests/test_grad_conformance.py and a ragged case under every
              forward and backward plan and split counts 1 and 3, then
              llama4-scout-17b-a16e's expert GEMMs (16 experts, 256 rows
              each, 5120 <-> 8192) at the path's plans, fp32 (1e-5, scaled
              as phase 19 for a contraction over 4096 terms) and bf16
              (5e-2); every batch slice bitwise the 2-D kernel's at the
              same plan; every backward plan bitwise the path's; reruns
              bitwise.
 26. engine_bmm  this slice's bmm path: make_engine("cuda").bmm at the
              first expert shape and autograd's gradient of sum(y**2),
              with the launch counts set to 0 just before and read just
              after (one launch of each bmm kernel, one `bmm` dispatch),
              against `eager` on the card: y within the phase-25 bar, the
              gradients within 1e-4 (two chained GEMMs, as phase 7's).
 27. timing_bmm  each bmm kernel at that shape: kernel, plain, torch.bmm
              (TF32 off) and bound ms (2 B M K N operations at the FFMA
              rate, or each operand read once and the output written once).
 28. conv_direct  this slice's direct-conv path: the 11 DARKNET19_CFG
              convolutions at batch 8 and full width (224^2 x 3 through
              14^2 x 512, all stride 1, 3x3 and 1x1), each input padded
              outside, through conv2d_direct with the launch counts set to
              0 just before and read just after (11 launches); then fp32
              and bf16, each against its plain version and against the
              `cuda` engine's im2col conv2d (linear, no scale or shift),
              bars as phase 25, reruns bitwise, every plan
              (conv_direct.PLANS) bitwise the path plan's, also at a ragged
              grid (CONV_RAGGED); then per layer the plan, kernel, plain,
              im2col and cuDNN F.conv2d (TF32 off, set here) device ms over
              CUDA-graph replays, the kernel's enqueued ms, and the
              bound.
 29. check_regimes (run after phase 11) at every GEMM shape of qwen2-0.5b
              and mamba2-1.3b, M 1, 4, 8, 64 (regime A's) and 200 (B's),
              fp32 (with residuals) and bf16: every plan of both regimes
              gives the path's plan's bits.
 30. timing_figure3 (run after phase 27) the paper's Figure 3 GEMM (M 2048,
              K 4096, N 16384, fp32) against its plain version, then kernel,
              plain, torch.matmul (cuBLAS fp32, TF32 off) and bound ms,
              TFLOP/s and the bound share.
 31. check_moe  llama4-scout-17b-a16e's fused GEMMs (q, k, v, o, the router
              at N 16 with fp32 out, the shared expert's gate / up / down,
              the untied head) at the MoE phases' rows (2 and 4 decode rows,
              the 256-token prefill; the head at the decode rows), each
              against its plain version as phase 2 with the path's plan,
              and the router under every plan (gemm.PLANS), each plan's bits
              the path plan's; the expert bmm (16 experts, 5120 <-> 8192)
              at 16 and 32 dispatch rows (2 and 4 decode rows x capacity 8,
              the 2 x 128 prefill x capacity 16) against its plain version
              (bars as phase 25), every forward plan's bits the path plan's,
              every batch slice the 2-D kernel's, reruns bitwise; the
              attention kernels at 40 / 8 heads of 128 (G = 5): the
              flash forward at the 2 x 128 prefill, the decode kernel at 2
              and 4 rows against 256 cache rows (checks of phases 9-10).
 32. moe      full-width llama4-scout-17b-a16e at MOE_LAYERS of its 48
              layers (431 GB in fp32 at 48; random weights drawn on the card
              from a seed): the prefill of 2 x 128 tokens and 3 decode steps
              against a 256-row cache on `cuda` and on `eager`, one
              parameter dict.  Routes first: a token that `cuda` routes to
              other experts than `eager` is allowed only where eager's top-2
              router probability margin is below 10 x the routers' max-abs
              probability difference (each flip printed), and its batch row
              leaves the comparison; the other rows' prefill and decode
              logits and caches within 1e-4.  Exact launch counts with the
              counts set to 0 just before each part (per layer and call 8
              fused GEMMs, 3 expert bmm, 1 flash forward or decode launch;
              the head 1 GEMM a call; the forward launches by regime),
              every engine op on `cuda`, `eager` launching none; peak GB.
 33. moe_serve  the MoE main path: the slot ServingEngine on `cuda`, 4
              slots, max_len 256, 8 requests (prompts 16-64 tokens,
              max_new 4-16, numpy seed), the launch counts set to 0 just
              before and read just after, exactly the decode step's launches
              times the steps; every request completes; each stream equals
              the slot engine's on `eager` on the card, or differs first
              where eager's top-2 logit margin is below 10 x phase 32's
              logits error; p50 / p99, tokens/s, peak GB.
 34. timing_moe  a moe_serve decode step: host ms on `cuda` and `eager`,
              the device ms by kernel (torch.profiler) and the busy share;
              the three expert bmm launches of one layer at 16, 32 and 80
              dispatch rows (2 and 4 decode rows, the 2 x 128 prefill, a
              1 x 1024 prefill), each kernel, plain, torch.bmm (TF32 off)
              and bound ms (bytes at these rows: 2.68 GB a weight); the
              fused GEMMs of one moe_serve decode dispatch over the
              parameters' own weights: kernel, plain, torch.matmul and
              bound ms; the flash forward at the 2 x 128 prefill and the
              decode kernel at a moe_serve step (G = 5) as phase 15 times
              them.
 35. check_frontends  (twice: internvl2-2b, then hubert-xlarge) the
              projector GEMMs (vision: LayerNorm's output @ w1 with b1 as the
              shift and gelu, then @ w2 + b2, at 2 x 256 patch rows; audio:
              @ w + b at 4 x 500 frames) and the untied head at the phases'
              last-position rows, against their plain versions as phase 2
              with the path's plan; the flash forward at the model's
              attention (2 x 320, 16 / 8 heads of 128, causal; 4 x 500,
              16 / 16 heads of 80, not causal) and the decode kernel at a
              vlm decode step (2 rows, G = 2, against 336 rows), fp32 and
              bf16, as phases 9-10, every plan bitwise the path plan's.
 36. vlm      internvl2-2b at full width and depth (24 layers, 1.9e9
              parameters, random from a seed, projector biases and norms
              moved off their init): a prefill of 2 requests x (256 patch
              embeddings and 64 text tokens) through make_prefill_step on
              the inputs dict of configs.base.input_tensors, then 16 greedy
              decode steps through make_decode_step on caches from
              kvcache.cache_init (336 rows: the split-KV kernel, G = 2), on
              `cuda` and on `eager`, each from its own greedy tokens: the
              tokens equal (a difference allowed only where eager's top-2
              margin is below 10 x the logits error), prefill and decode
              logits and caches within 1e-4, exact launch counts (with the
              counts set to 0 just before each part) and regimes, every
              flash forward causal at head dim 128, every op on `cuda`,
              `eager` launching none; host ms, peak GB.  Phases 36 and 42
              share `prefill_decode_phase`.
 37. timing_frontends (internvl2-2b)  the prefill and a decode step: host
              ms, device ms by kernel (torch.profiler), busy share; the
              flash forward at the prefill and the decode kernel at a step
              as phase 15 times them (SDPA as the library); the projector
              GEMMs and the head over the parameters' own weights: kernel,
              plain, torch.matmul and bound ms.  The model is then freed.
 38. check_frontends (hubert-xlarge), as phase 35.
 39. audio    hubert-xlarge at full width and depth (48 layers, 0.96e9
              parameters): make_forward_step over frames (4, 500, 512), 10 s
              of 16 kHz audio at 50 frames a second, on `cuda` and on
              `eager`: logits within 1e-4, exact launch counts (with the
              counts set to 0 just before), every attention launch at head
              dim 80 and not causal; host ms, peak GB.
 40. timing_frontends (hubert-xlarge)  the forward as phase 37, the flash
              forward at head dim 80 under both plans against SDPA and its
              bound, the projection GEMM and the head.  The model is freed.
 41. check_hybrid  zamba2-7b's GEMMs (each distinct (K, N) of the mamba
              projections, the shared block's win, q, k, v, o, gelu up,
              down and wout, the tied head) at every row count phases
              42-43 give them: the decode rows (2), the prefill's (1024),
              a hybrid_serve step's slots (4) and each hybrid_serve
              admission's prompt but its last token (the head at 2 and 4);
              the SSD kernel at the prefill shape (2 x 512, 112 heads of
              64, N 64, chunk 256) and at each admission; the flash
              forward at head dim 112 (32 / 32 heads, causal) at the 2 x
              512 prefill and at each admission (1 x 15-63); the decode
              kernel at G = 1 (2 rows against 528, 4 rows against 256);
              fp32 and bf16, each against its plain version as phases 2,
              9-10 and 20, every plan bitwise the path plan's.
 42. hybrid   zamba2-7b at full width and depth (81 mamba layers in 13
              super entries of 6 and a tail of 3, the shared attention +
              MLP block at every super entry, 6.6e9 parameters, 26.5 GB,
              random from a seed, dt bias, A, D and the shared norms moved
              off their init): a prefill of 2 x 512 tokens through
              make_prefill_step, then 16 greedy decode steps through
              make_decode_step on caches from kvcache.cache_init (528
              rows: the split-KV kernel at head dim 112), on `cuda` and on
              `eager`, each from its own greedy tokens: the 17 tokens
              equal, logits, every layer's mamba caches and the shared K /
              V within 1e-4, exact launch counts (with the counts set to 0
              just before each part: per prefill 591 GEMMs, 13 flash
              forwards at (112, causal), 81 SSD scans; per decode step 591
              GEMMs and 13 split-KV launches) and regimes, every op on
              `cuda`, `eager` launching none; host ms, peak GB.
 43. hybrid_serve  the slot ServingEngine on `cuda`, 4 slots, max_len 256,
              8 requests (prompts 16-64 tokens, max_new 4-12, numpy seed),
              the counts set to 0 just before and read just after: each
              admission zeroes the slot's mamba rows and prefills the
              prompt (SSD and flash forward), each step's shared block on
              the split-KV kernel, launches exact; each reused-slot
              request's stream equals its stream alone; every stream
              equals the slot engine's on `eager` on the card.
 44. timing_hybrid  the prefill and a decode step: host ms, device ms by
              kernel (torch.profiler), busy share; the flash forward at
              the prefill and the decode kernel at a step (SDPA as the
              library), the SSD kernel at the prefill shape, and a decode
              dispatch's GEMMs over the parameters' own weights (each
              kind's launches in one CUDA graph): kernel, plain, library
              and bound ms.  The model is freed.
 45. check_mla  deepseek-v2-lite-16b's fused GEMMs (wq N 3072, w_dkv N
              576, w_uk / w_uv K 512 in the prefill, wo, the dense layer's
              SwiGLU of 10944, the router N 64, the shared experts' 2816,
              the head N 102400) at the rows phases 46-47 give them (2,
              4, 1024; the head at 2 and 4), the expert bmm (64 experts,
              2048 <-> 1408) at 16, 32 and 128 dispatch rows and the two
              absorbed einsums on the bmm kernel at 2 and 4 rows (every
              plan bitwise the path plan's, slices the 2-D kernel's); the
              flash forward at head dim 192 (16 / 16 heads, the 32-lane
              plan alone: B 1-2, S 16-512, causal and not, a kv_len with a
              0) and the split-KV decode at 576 (16 heads over one latent
              kv-head: Sq 1 / 4 / 8 against 256 / 1024 rows, 47 splits,
              the mla and mla_serve steps), fp32 and bf16, as phases 9-10
              (the merge bitwise `combine`, the sentinels exact, the
              one-split decode bitwise the forward); the forward's 8-lane
              plans and dQ / dK / dV at 576 refused by name with no
              launch.  The MLA phases draw from a generator of their
              own (MLA_SEED), so every earlier phase's draws, and errors,
              stay as they were.  Then, on a generator of their own
              (MLA_FWD_SEED): the flash forward at 576 (K and V in 32-key
              half tiles, the 32-lane plan alone) at mla_short_serve's
              step (4 x 1 against 128 rows, kv_len [128, 42, 1, 0], not
              causal), a 2 x 64 chunk against 128 rows and mla_chunk's
              second chunk (2 x 64 against 256 rows, kv_len 128, causal),
              fp32 and bf16, the lse launch and every plan bitwise; the
              chunk's GEMMs and absorbed einsums at its 128 rows.
 46. mla      deepseek-v2-lite-16b at full width and depth (27 layers: one
              dense, 26 of 64 routed experts top-6 and 2 shared; 15.7e9
              parameters, 62.8 GB, random from a seed, norms moved off
              1): a prefill of 2 x 512 tokens through make_prefill_step
              (the flash forward at head dim 192), then 16 greedy decode
              steps through make_decode_step on latent caches from
              kvcache.cache_init (528 rows: the absorbed decode, the
              split-KV kernel at 576 and the einsums on the bmm kernel),
              on `cuda` and on `eager`, through `prefill_decode_phase`:
              routes first (`eager` runs `cuda`'s expert choices, so a
              near tie that flips a route cannot move one engine's later
              layers away from the other's; each route eager's own
              routers chose otherwise must be a near tie, its margin
              below MARGIN_FACTOR x the routers' probability error),
              logits over the real vocabulary and the
              c_kv / k_rope caches within 1e-4, the tokens equal, exact
              launch counts (per prefill 243 GEMMs, 27 flash forwards at
              (192, causal), 78 expert bmm; per step 189 GEMMs, 27
              split-KV launches, 132 bmm) and regimes; host ms, peak GB.
 47. mla_serve  the slot ServingEngine on `cuda`, 4 slots, max_len 256, 8
              requests (prompts 8-24 tokens, max_new 4-8, numpy seed) on
              the replay route, the counts set to 0 just before and read
              just after, launches exact; each reused-slot request's
              stream equals its stream alone; every stream equals the
              slot engine's on `eager` on the card (running `cuda`'s
              expert choices, as in phase 46), or differs first where
              eager's top-2 logit margin is below MARGIN_FACTOR x phase
              46's logits error.
 59. mla_short_serve (run after phase 47)  as phase 47, on the slot
              engine at its defaults (4 slots of 128 rows): every step's
              absorbed attention is the flash forward at (576, not
              causal), launches exact (per step 27 flash forwards, no
              split-KV launch).
 60. mla_chunk (run after phase 59)  make_decode_step on `cuda` and
              `eager` at batch 2 on zeroed 256-row latent caches, fed two
              64-token chunks at positions 0 and 64 (past DECODE_MAX_SQ:
              the flash forward at (576, causal) against kv_len = pos +
              64), the counts set to 0 just before each chunk: launches
              exact (per chunk 189 GEMMs, 27 flash forwards, 132 bmm, no
              split-KV launch), routes first (`eager` runs `cuda`'s expert
              choices), logits over the real vocabulary and the caches
              within 1e-4, greedy tokens equal up to a near tie.
 48. timing_mla  the prefill and a decode step: host ms, device ms by
              kernel (torch.profiler), busy share; the flash forward at
              the prefill (2 x 512, D 192) and the decode kernel at a
              step (D 576, 528 rows), kernel, plain, bound and SDPA ms;
              a decode dispatch's GEMMs over the model's own weights
              against torch.matmul; one MoE layer's expert bmm at the
              decode's 16 rows against torch.bmm; the two absorbed
              einsums: the whole einsum, the kernel on y in (E, K, N)
              order, y's permuted copy alone, plain and torch.bmm; the
              flash forward at 576 at phase 59's step and phase 60's
              second chunk, kernel, plain, bound and SDPA ms (its own
              generator).  The model is freed.
 49. check_attn_bwd (80, 112, 192; run after phase 16)  the lse
              forward, dQ and dK / dV at hubert-xlarge's head dim 80,
              zamba2-7b's 112 and deepseek-v2-lite-16b's 192 as phase 16:
              its grid, then the model's training shape (4 x 500, 16 / 16
              heads, not causal; 2 x 512, 32 / 32, causal; 2 x 512, 16 /
              16, causal), fp32 and bf16, every dQ plan the head dim admits
              (at 192 the 16-row plan alone) and reruns bitwise, dead rows
              exact 0; dQ, dK / dV and FlashAttention refused at 576 with
              no launch.  Each head dim draws from a generator of its own
              (TRAIN_SEED + the head dim).
 50. ssm_train (run after phase 24)  mamba2-1.3b at full width and depth
              (48 layers), batch 4 x 1024 (4 SSD chunks a row): first each
              distinct GEMM of its train step (M 4096; the tied head at a
              CE chunk's 2048 rows, N 50288), dX and dW against their plain
              versions (the fp32 bar of a contraction past 4096 terms
              `gemm_tol`'s) and every backward plan bitwise the path's;
              then as phase 17 on `cuda`, `eager` and `ref`: the step-1
              loss (<= 1e-5) and every gradient (<= 1e-4, or 10 x the same
              tensor's ref-eager gap), two `cuda` runs bitwise, 3 AdamW
              steps through train_loop (`cuda`, then `eager`, then `ref`)
              within the drift bars, the parameters' drift also taken
              over the elements of a sharp step-1 gradient apart; exact
              launches a step (580 residual forwards, all regime B, 290
              dX, 290 dW, 144 reduces, 96 SSD dispatches in the einsum
              form, no SSD launch), every op on `cuda`, peak GB; then a
              `no_grad` prefill of the trained model: one SSD launch a
              layer, within 1e-4 of `eager`'s.  Draws from TRAIN_SEED.
 51. timing_ssm_train  a train step's ms, tokens/s, peak GB and device
              time by kernel, `cuda` and `eager`.
 52. audio_train (run after phase 40)  hubert-xlarge at full width and
              depth, 4 x 500 frames, as phase 50 (GEMMs at M 2000, the
              projection 512 -> 1280 once a step: it is outside remat; 96
              lse forwards, 48 dQ, 48 dK / dV at head dim 80 a step) but
              trained through make_train_step on standard-normal frames
              (`audio_batch`: SyntheticLM's frames hold one value a frame,
              which the layer norm turns into an all-zero forward whose
              gradient overflows), the `ref` run in two microbatches (ref
              computes eager's bits here).
 53. timing_audio_train  as phase 51, and the lse forward, dQ and dK / dV
              at 4 x 500: kernel, plain, bound (6 D / 8 D FLOPs a live pair
              and head at the FFMA rate) and SDPA (TF32 off) ms.
 54. hybrid_train (run after phase 44)  zamba2-7b at full width, 15 of
              its 81 layers (two super entries of 6 with the shared block,
              then a tail of 3: 1.48e9 parameters; 81 layers need 106 GB
              with gradients and moments), 2 x 512, as phase 50 (4 lse, 2
              dQ, 2 dK / dV at head dim 112 and 30 SSD einsum dispatches a
              step; the prefill 15 SSD launches).
 55. timing_hybrid_train  as phase 53 at 2 x 512, head dim 112, causal.
 56. mla_train (run after phase 48)  deepseek-v2-lite-16b at full width,
              3 of its 27 layers (the dense first layer and two MoE
              layers: 1.67e9 parameters, 26.7 GB with gradients and AdamW
              moments; 27 layers need 251 GB), 2 x 512, as phase 50, its
              own generator (MLA_TRAIN["gen"]): the GEMMs' dX / dW and the
              expert bmm's (64 experts, 128 dispatch rows, 2048 <-> 1408:
              every kernel against its plain version, every backward plan
              and batch slice bitwise) checked; step 1 on `cuda` (twice,
              bitwise, routes too), `eager` and `ref`, the two running
              `cuda`'s expert choices per layer (`RouteLog` / `RouteReplay`
              by layer: the remat recompute takes its layer's recorded
              route), each route they would have chosen otherwise a near
              tie; 3 AdamW steps through make_train_step on train_loop's
              parameters, batches and optimizer, `cuda` first, the others
              replaying its routes (`ref` computes `eager`'s bits here, so
              its trajectory takes the CE in chunks of 256: the same loss
              summed in another order), the parameters after 3 steps held
              to 1e-4 or 10 x ref's drift, per tensor, over the elements
              whose step-1 gradient clears 10 x its tensor's cuda-eager
              error on both engines (the others may take opposite +-lr
              AdamW steps); exact launches a step (54
              residual forwards, 27 dX, 27 dW, 30 reduces, 12 expert bmm
              forwards, 6 bmm_bwd_dx, 6 bmm_bwd_dw, 6 lse forwards, 3 dQ
              and 3 dK / dV at head dim 192), every op on `cuda`; a
              `no_grad` prefill of the trained model (3 flash forwards, 6
              expert bmm) against `eager` on `cuda`'s routes.
 57. timing_mla_train  as phase 53 at 2 x 512, head dim 192, causal (the
              16-row dQ plan), and the expert bmm's dX and dW at each
              expert shape: kernel, plain, torch.bmm and bound ms, summed
              over a MoE layer's three launches.
 58. moe_train  llama4-scout-17b-a16e at full width, 1 of 48 layers
              (4.27e9 parameters, 17.1 GB; with AdamW moments one engine
              needs 68 GB, so no trajectory), 2 x 512: its GEMMs and expert
              bmm (16 experts, 80 rows: capacity 40, 5120 <-> 8192) checked
              as phase 56, then step 1 only, as there (G = 5 attention at
              128, top-1 routing with a shared expert), each gradient set
              freed once its errors are taken: the peak held to
              MOE_TRAIN's bound; then its expert bmm's dX and dW timed as
              phase 57.
 61. autotune (run after phase 19)  the measured autotuner
              (core/autotune.py, the registry's plan cache) with its table
              in a fresh temporary directory (REPRO_AUTOTUNE_CACHE), on
              data of its own generators: full-width DARKNET19_CFG serving
              a batch of 8 through compile_cache(autotune=...) and
              CNNServingEngine, one make_cnn_train_step step at batch 8
              (the gemm_bwd keys), and one full-width, full-depth
              qwen2-0.5b make_train_step step at 2 x 512 (attention and
              attention_bwd at head dim 64, gemm_bwd at LM shapes).  Each
              path runs under `heuristic` and then, the cache cleared,
              under `measure`: outputs, gradients, parameters and AdamW
              moments bitwise equal, the same keys; then a simulated
              fresh process (`clear_tile_cache()`, `autotune.reset()`)
              runs it again: bitwise equal, nothing measured, every
              measured key persisted, the heuristic run's launches but
              the forward's regimes (the split counts are the shape's).
              One line per measured key (heuristic and measured pick,
              both times, the ratio), one per path (a forward / step
              under both picks by CUDA events, in turns: the rules',
              the measured, the measured, the rules'; the card's name and
              power limit).  The cache is cleared and the policy restored at
              the end.
 62. autotune_mla (run after phase 48, while the model is held)  as phase
              61 for deepseek-v2-lite-16b at full width and depth: 4
              decode steps of the slot engine (2 slots of 256 latent rows:
              regime-A GEMMs at M 2, the expert bmm and the absorbed
              einsums through `einsum`, the split-KV decode at 576), the
              tokens and the latent caches bitwise equal; every
              attention_decode key stays `decode_splits`', untimed.
 63. check_sharded (run after phase 15, the parent's cache emptied)
              two ranks on cuda:0 over gloo (`launch.mesh.spawn`, each
              rank drawing from SHARD_SEED's generator, never `cgen`),
              `launch.mesh_checks.check_ops` at `sharded_cases`: every
              sharded op of the `sharded_cuda` backend against its local
              launch of the `cuda` wrapper on the same operands and
              against its plain version (the wrapper on host copies), at
              qwen2-0.5b's decode (4 slots) and prefill (a 64-token chunk)
              shapes and a DARKNET19 conv layer at batch 2: row-sharded
              GEMMs, the bmm, the im2col conv and batch-sharded attention
              bit for bit, head-sharded attention (("model",), KV 2) and
              the sequence split (3 rows against 512 keys, Sq 1 and 4)
              within 1e-5 max-relative, the split bit for bit a
              one-process loop of the spans' partials and `combine`;
              `ops.attention_partial` (the lse forward at relative
              extents above Skv and <= 0, Sq 1 / 4 / 8) within 1e-5 of
              its plain version, every sentinel row exact; every case's
              kernel launched on the card, every gather staged through
              the host; both ranks' results equal.
 64. sharded_serve  full-width, full-depth qwen2-0.5b on both ranks
              (`lm_params`' seed-4 card generator in every rank, the
              ranks' parameter checksums all-gathered and equal),
              `launch.mesh_checks.serve_streams` at SHARDED_SERVE's
              requests: the slot engine on ("data",) with 4 slots of 256
              rows (batch and rows), on ("data",) with 3 slots of 512 rows
              (the sequence split) and on ("model",) under "tp" (heads),
              the paged engine on ("data",); counts set to 0 just before
              each run and read just after.  Streams equal on both ranks
              and equal to rank 0's unsharded `cuda` engine on the same
              parameters, a differing token allowed only at a near tie
              (the rule of phase 14); every dispatch on `sharded_cuda`;
              per rank the launches, the collectives per step and the
              host-staged copies, and ms per step sharded and unsharded
              (the ranks share one card: no measure of distribution).
 65. timing_sharded  the kernels at the shards' shapes, as phase 12 and
              `timing_lm`: the decode step's GEMMs at M 2 (4 slots over 2
              ranks), the split-KV decode at 2 rows against 256, the lse
              forward of both ranks' spans (3 rows against 256 keys each
              at the relative extents of kv_len 3 / 300 / 512).
Then the kernels line (51 entries: the lse forward, dQ and dK / dV at 80,
112 and 192, the expert bmm's dX and dW on mla_train and moe_train, the
flash forward at 576 on mla_short_serve and mla_chunk, and the GEMM, the
split-KV decode and the lse forward on the sharded paths added), and last
the result line.  Every JSON line carries `t`, the
seconds since the script started.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.base import (ShapeConfig, get_arch,  # noqa: E402
                                       input_tensors, reduced)
from repro_torch.configs.darknet_ref import DARKNET19_CFG  # noqa: E402
from repro_torch.core import autotune, backends, make_engine  # noqa: E402
from repro_torch.core.darknet import cfg as darknet_cfg  # noqa: E402
from repro_torch.core.darknet.network import Network  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import build, gemm, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import (conv_direct, ssd, time_attention,  # noqa: E402
                                  time_ssd)
from repro_torch.kernels.common import ACTIVATIONS, epilogue  # noqa: E402
from repro_torch.kernels.ref import attention_mask  # noqa: E402
from repro_torch.launch import mesh, mesh_checks  # noqa: E402
from repro_torch.launch.fault import FailureInjected  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve import kvcache, kvpool  # noqa: E402
from repro_torch.serve.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serve.scheduler import PagedServingEngine  # noqa: E402
from repro_torch.serve.serve_step import (greedy_sample,  # noqa: E402
                                          make_decode_step,
                                          make_forward_step, make_paged_step,
                                          make_prefill_step)
from repro_torch.serve.frontend import (CNNServingEngine,  # noqa: E402
                                        ImageRequest)
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import (cnn_loss_fn,  # noqa: E402
                                          make_cnn_train_step,
                                          make_train_step)
from repro_torch.tree import flatten, unflatten_like  # noqa: E402

MATMUL_CASES = [(2, 64, 10), (32, 128, 256), (32, 256, 128), (33, 177, 99)]
BURSTS = (1, 3, 8, 2, 9, 4, 1, 5)
BUCKETS = (1, 2, 4, 8)
FP32_TOL, BF16_TOL = 1e-5, 5e-2
LOGIT_TOL, PROB_TOL = 1e-4, 1e-3
TRAIN_TOL = 1e-4  # gradients, parameters, moments: 12 chained fp32 layers
# After the first step the two trajectories are held to TRAIN_TOL or to
# FLOOR_FACTOR times the distance between two correct fp32 programs (eager
# on the card and on the host), whichever is larger.
FLOOR_FACTOR = 10
SOURCE = "src/repro_torch/kernels/csrc/gemm.cu"
SOURCE_BWD = "src/repro_torch/kernels/csrc/gemm_bwd.cu"
REPLACES = "src/repro/kernels/gemm.py:75"  # _gemm_kernel
REPLACES_DX = "src/repro/kernels/gemm.py:251"  # gemm_bwd_dx's pallas_call
REPLACES_DW = "src/repro/kernels/gemm.py:283"  # gemm_bwd_dw's pallas_call
TRAIN_BATCH, TRAIN_STEPS, BIG_BATCH = 8, 3, 64
SOURCE_ATTN = "src/repro_torch/kernels/csrc/flash_attention.cu"
SOURCE_DECODE = "src/repro_torch/kernels/csrc/flash_decode.cu"
REPLACES_ATTN = "src/repro/kernels/flash_attention.py:354"  # _flash_kernel
REPLACES_DECODE = "src/repro/kernels/flash_decode.py:168"  # _decode_kernel
HEAD_RATIOS = ((16, 16), (14, 2), (8, 1))
LM_ARCH = "qwen2-0.5b"
LM_PREFILL, LM_CACHE = 512, 1024       # lm phase: prompt and cache rows
SERVE = dict(kv_blocks=256, block_size=16, max_len=1024, chunk=64,
             prefill_budget=256, batch_buckets=(1, 2, 4, 8))
N_REQUESTS = 24
LM_GEMM_ROWS = (1, 8, 64)  # decode row, batch-8 decode, 64-token chunk
REGIME_ROWS = (1, 4, 8, 64, 200)  # check_regimes: A's rows and one of B's
FIGURE3 = (2048, 4096, 16384)  # benchmarks/figure3_gemm.py's fp32 GEMM
MARGIN_FACTOR = 10  # a slot/paged token mismatch needs margin < 10 x error
SOURCE_ATTN_BWD = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
REPLACES_DQ = "src/repro/kernels/flash_attention.py:409"  # _flash_bwd_dq_kernel
REPLACES_DKV = "src/repro/kernels/flash_attention.py:441"  # _flash_bwd_dkv_kernel
LM_TRAIN = dict(batch=8, seq=512, steps=3, seed=0)  # lm_train's train_loop
FLOOR_BACKEND = "ref"  # the second correct fp32 program of phase 17
RESTART = dict(steps=4, batch=2, seq=64, ckpt_every=2, seed=1)
RESTART_FAIL_AT = 3
BWD_SHAPES = ((64, 64), (100, 100), (40, 130))  # check_attn_bwd's (Sq, Skv)
SOURCE_SSD = "src/repro_torch/kernels/csrc/ssd.cu"
REPLACES_SSD = "src/repro/kernels/ssd.py:97"  # ssd_scan -> _ssd_kernel
SSM_ARCH = "mamba2-1.3b"
SSM_PREFILL = (4, 1000)  # ssm phase: batch x prompt tokens
SSM_DECODE_STEPS = 16
SSM_SERVE = dict(slots=4, requests=8, prompt=(8, 48), new=(4, 16),
                 max_len=128)
# check_ssd's (batch, S, H, P, G, N, chunk): S a multiple of the chunk and
# ragged, G 1 and 2, P 32 and 64, N 16 and 128, chunk 64 and 256, batch 1
# and 4 (the path's prefill shape is added)
# the engine bmm op: BMM_CASES of tests/test_grad_conformance.py plus a
# ragged case; llama4-scout-17b-a16e's expert GEMMs (configs/
# llama4_scout_17b.py: 16 experts, d_model 5120, expert d_ff 8192) at 256
# rows per expert (a 4096-token batch, top-1): the up and down projections
BMM_CASES = [(2, 32, 16, 32), (3, 17, 23, 9), (5, 100, 70, 130)]
EXPERT_BMM = ((16, 256, 5120, 8192), (16, 256, 8192, 5120))
BMM_KERNELS = ("bmm_fwd", "bmm_bwd_dx", "bmm_bwd_dw")
REPLACES_BMM = "src/repro/kernels/gemm.py:479"  # _bmm_forward's pallas_call
REPLACES_BMM_DX = "src/repro/kernels/gemm.py:309"  # bmm_bwd_dx's
REPLACES_BMM_DW = "src/repro/kernels/gemm.py:336"  # bmm_bwd_dw's
SOURCE_CONV = "src/repro_torch/kernels/csrc/conv_direct.cu"
REPLACES_CONV = "src/repro/kernels/conv_direct.py:102"  # conv2d_direct's
CONV_BATCH = 8
# conv_direct's ragged grid: (batch, H = W - 3 (H odd) or W, Cin, Cout,
# kernel size), padded outside: Cin 3, 5, 12, 40; Cout 32, 48; OW not a
# multiple of any plan's tile
CONV_RAGGED = ((2, 37, 3, 32, 3), (2, 21, 5, 48, 3), (3, 19, 12, 32, 3),
               (2, 23, 12, 48, 1), (1, 30, 5, 32, 1), (2, 13, 40, 48, 3))
MIXED_TOL = 5e-2  # the bf16 bar: mixed rounds activations to bf16
MIXED_FLOOR_FACTOR = 1.5  # lm_mixed: times the drift of two mixed programs
MIXED_PROMPT = (2, 256)
SSD_GRID = ((1, 512, 4, 64, 1, 128, 256), (4, 300, 8, 32, 2, 16, 64),
            (1, 1000, 8, 64, 2, 128, 256), (4, 130, 4, 32, 1, 128, 64),
            (1, 256, 4, 32, 2, 16, 256))
# the MoE family: llama4-scout-17b-a16e (configs/llama4_scout_17b.py) at
# full width and MOE_LAYERS of its 48 layers: the whole model holds 108e9
# parameters, 431 GB in fp32, and the card holds 80 GB
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_LAYERS = 4
MOE_PREFILL = (2, 128)  # moe: batch x prompt tokens (capacity 16)
MOE_DECODE_STEPS = 3
MOE_CACHE = 256  # moe's cache rows: decode takes the split-KV kernel
MOE_SERVE = dict(slots=4, requests=8, prompt=(16, 64), new=(4, 16),
                 max_len=256)
# timing_moe's expert bmm rows (B x capacity): a decode step of moe's 2
# rows, of moe_serve's 4 slots (= moe's 2 x 128 prefill), a 1024-token
# prefill of one row
MOE_BMM_ROWS = {"decode_b2": 16, "decode_b4_or_prefill_2x128": 32,
                "prefill_1x1024": 80}
VLM_ARCH = "internvl2-2b"
VLM_PREFILL = (2, 64)  # vlm: requests x text tokens, after 256 patches
VLM_DECODE_STEPS = 16  # the caches hold 320 + 16 = 336 rows
AUDIO_ARCH = "hubert-xlarge"
AUDIO_FRAMES = (4, 500)  # audio: 10 s of 16 kHz audio at 50 frames a second
HYBRID_ARCH = "zamba2-7b"
HYBRID_PREFILL = (2, 512)  # hybrid: batch x prompt tokens (two SSD chunks)
HYBRID_DECODE_STEPS = 16  # the caches hold 512 + 16 = 528 rows
# the slot engine's cache rows (256) give its decode steps the split-KV
# kernel (ops.DECODE_MIN_SKV)
HYBRID_SERVE = dict(slots=4, requests=8, prompt=(16, 64), new=(4, 12),
                    max_len=256)
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_PREFILL = (2, 512)  # mla: batch x prompt tokens (capacity 64)
MLA_DECODE_STEPS = 16  # the latent caches hold 512 + 16 = 528 rows
MLA_SERVE = dict(slots=4, requests=8, prompt=(8, 24), new=(4, 8),
                 max_len=256)
MLA_SEED = 61  # the MLA phases' own generator (check_mla, timing_mla)
# The absorbed attention where it takes the flash forward at 576: a slot
# step of mla_short_serve (4 slots against the engine's default 128 rows)
# and mla_chunk's second chunk (2 x 64 tokens at position 64 of 256 rows);
# (b, sq, skv, kv_len list, causal).  Their checks and timings draw from a
# generator of their own (MLA_FWD_SEED), so every MLA error field before
# them repeats.
MLA_SHORT_STEP = (4, 1, 128, [128, 42, 1, 0], False)
MLA_CHUNK = dict(batch=2, chunk=64, chunks=2, cache_rows=256, seed=68)
MLA_CHUNK_STEP = (2, 64, 256, [128, 128], True)
MLA_FWD_SEED = 67
# The training phases of the SSM, audio and hybrid families (train_loop's
# seeds, batch x seq, AdamW steps); their GEMM checks and timings draw from
# a generator of their own (TRAIN_SEED), check_attn_bwd at 80 / 112 from
# TRAIN_SEED + the head dim.
TRAIN_SEED = 81
SSM_TRAIN = dict(batch=4, seq=1024, steps=3, seed=71)  # 4 SSD chunks a row
AUDIO_TRAIN = dict(batch=4, seq=500, steps=3, seed=72)
HYBRID_TRAIN = dict(batch=2, seq=512, steps=3, seed=73, layers=15,
                    reduced=["n_layers 81 -> 15: two super entries of 6 and "
                             "a tail of 3 (1.48e9 parameters, 23.6 GB with "
                             "gradients and AdamW moments; 81 layers need "
                             "106 GB)"])
TRAIN_ATTN = {80: (AUDIO_ARCH, (4, 500), False),  # head dim: arch, (b, s),
              112: (HYBRID_ARCH, (2, 512), True),  # causal
              192: (MLA_ARCH, (2, 512), True)}
# Training the MoE programs: deepseek-v2-lite-16b (MLA) at full width, cut
# to its dense first layer and two MoE layers, and llama4-scout-17b-a16e at
# full width, one layer, step 1 only (steps 0: no AdamW trajectory).  Each
# draws its checks and timings from a generator of its own (`gen`).
# Phase autotune's paths, each on data of its own generator.
SHARD_SEED = 301  # check_sharded's ranks' generator and timing_sharded's
# sharded_serve's stream: each request's prompt and max_new from this seed
SHARDED_SERVE = dict(requests=6, prompt=(4, 24), new=(8, 12), seed=302)
SHARD_WORLD = 2  # ranks, all on cuda:0
AUTOTUNE_CNN = dict(batch=8, seed=91)  # DARKNET19 serving and a train step
AUTOTUNE_LM = dict(batch=2, seq=512, seed=92)  # one qwen2-0.5b train step
AUTOTUNE_MLA = dict(slots=2, max_len=256, new=4, seed=93)  # 4 decode steps
MLA_TRAIN = dict(batch=2, seq=512, steps=3, seed=76, gen=77, layers=3,
                 sharp_tol=TRAIN_TOL,
                 reduced=["n_layers 27 -> 3: the dense first layer and two "
                          "MoE layers, so dense -> MoE and MoE -> MoE both "
                          "run (1.67e9 parameters, 26.7 GB with gradients "
                          "and AdamW moments; 27 layers hold 1.57e10, 251 "
                          "GB to train)"])
MOE_TRAIN = dict(batch=2, seq=512, steps=0, seed=78, gen=79, layers=1,
                 peak_gb_bound=60.0,
                 reduced=["n_layers 48 -> 1 (4.27e9 parameters, 17.1 GB "
                          "in fp32; with AdamW moments one engine's state "
                          "is 68 GB, so step 1 only, no trajectory)"])
_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - _T0,
                                                 1), **fields}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def relmax(a: torch.Tensor, b: torch.Tensor, mask=None) -> float:
    """max |a - b| / (max |b| + 1e-12) in fp64, over pieces of 2**24
    elements, so that a gradient the size of llama4-scout's embedding
    (1.03e9 elements) takes no fp64 copy of its whole (each max is exact,
    so the pieces give the bits of one pass); with `mask` the numerator
    over its True elements alone."""
    diff, peak = pieces_max(a, b, torch.float64, mask)
    return float(diff / (peak + 1e-12))


def pieces_max(a: torch.Tensor, b: torch.Tensor, dtype, mask=None):
    """(max |a - b|, max |b|) as 0-d tensors, each piece of 2**24
    elements taken in `dtype` (None: a's), b broadcast against a; with
    `mask` (bool, a's shape) the first max over its True elements."""
    a, b = a.detach(), b.detach().to(a.device)
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    a, b = a.reshape(-1), b.reshape(-1)
    dtype = dtype or a.dtype
    diff = peak = torch.zeros((), dtype=dtype, device=a.device)
    for i in range(0, a.numel(), 1 << 24):
        x, y = a[i:i + (1 << 24)].to(dtype), b[i:i + (1 << 24)].to(dtype)
        d = (x - y).abs()
        if mask is not None:
            d = torch.where(mask.reshape(-1)[i:i + (1 << 24)], d, 0)
        diff = torch.maximum(diff, d.max())
        peak = torch.maximum(peak, y.abs().max())
    return diff, peak


def card_peaks(name: str) -> tuple[float, float]:
    """(fp32 FFMA FLOP/s, memory bytes/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 51e12, 2.0e12
    if "NVL" in name:
        return 60e12, 3.9e12
    return 67e12, 3.35e12  # SXM


def path_gemms(net: Network, batch: int) -> list[dict]:
    """The GEMMs one forward of `net` runs at `batch`, in layer order:
    (m, k, n) and the fused epilogue, from the layer plan."""
    out, hwc = [], net.in_shape
    for p in net.plans:
        o = p.options
        if p.type == "convolutional":
            size = o.get("size", 3)
            bn = bool(o.get("batch_normalize", 0))
            out.append({"layer": p.index,
                        "m": batch * p.out_shape[0] * p.out_shape[1],
                        "k": size * size * hwc[2], "n": p.out_shape[2],
                        "act": o.get("activation", "leaky"),
                        "scale": bn, "shift": True})
        elif p.type == "connected":
            out.append({"layer": p.index, "m": batch,
                        "k": math.prod(hwc), "n": p.out_shape[2],
                        "act": o.get("activation", "linear"),
                        "scale": False, "shift": True})
        hwc = p.out_shape
    return out


def randomize_bn(net: Network, gen: torch.Generator) -> None:
    """Non-trivial BN statistics: the init values 1/0/0/1 would hide a
    wrong fold."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            n = p.shape[0]
            if name.endswith(".gamma") or name.endswith(".var"):
                p.copy_(torch.rand(n, generator=gen) + 0.5)
            elif name.endswith(".beta") or name.endswith(".mean"):
                p.copy_(torch.randn(n, generator=gen) * 0.1)


def operands(m, k, n, dtype, gen, trans=False):
    """GEMM operands drawn on the card from the CUDA generator `gen`; with
    `trans`, w is the (K, N) transpose of a row-major (N, K) tensor, as the
    tied LM head reads the embedding table."""
    dev = gen.device
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    shape = (n, k) if trans else (k, n)
    w = (torch.randn(shape, generator=gen, device=dev)
         / math.sqrt(k)).to(dtype)
    w = w.t() if trans else w
    scale = torch.rand(n, generator=gen, device=dev) + 0.5
    shift = torch.randn(n, generator=gen, device=dev) * 0.1
    return x, w, scale, shift


def check_shape(m, k, n, plans, gen, trans=False) -> dict:
    """Kernel vs plain at one shape over dtypes, activations, epilogues;
    with `trans` the kernel reads w transposed in place, and must give the
    bits of a row-major copy of w."""
    worst = {"fp32": 0.0, "bf16": 0.0}
    max_abs = 0.0
    for in_dt in (torch.float32, torch.bfloat16):
        x, w, scale, shift = operands(m, k, n, in_dt, gen, trans)
        w_rows = w.contiguous() if trans else None
        for out_dt in (torch.float32, torch.bfloat16):
            kind = ("fp32" if in_dt == out_dt == torch.float32 else "bf16")
            tol = FP32_TOL if kind == "fp32" else BF16_TOL
            for act in ACTIVATIONS:
                for sc, sh in ((None, None), (scale, None), (None, shift),
                               (scale, shift)):
                    want = gemm.gemm_fused_plain(x, w, sc, sh, act=act,
                                                 out_dtype=out_dt)
                    for plan in plans:
                        got = gemm.gemm_fused_fwd(x, w, sc, sh, act=act,
                                                  out_dtype=out_dt, plan=plan)
                        check(bool(torch.isfinite(got).all()),
                              f"non-finite kernel output at {(m, k, n)}")
                        err = relmax(got, want)
                        check(err <= tol, f"kernel vs plain at {(m, k, n)} "
                              f"{in_dt}->{out_dt} {act} scale={sc is not None}"
                              f" shift={sh is not None} plan={plan}: "
                              f"{err:.3e} > {tol:g}")
                        if trans:
                            check(torch.equal(got, gemm.gemm_fused_fwd(
                                x, w_rows, sc, sh, act=act, out_dtype=out_dt,
                                plan=plan)), f"transposed w changes the bits "
                                f"at {(m, k, n)} {in_dt} {act} plan={plan}")
                        worst[kind] = max(worst[kind], err)
                        if kind == "fp32":
                            max_abs = max(max_abs, float(
                                (got - want).abs().max()))
    return {"shape": [m, k, n], "plans": [list(p) for p in plans],
            "trans_w": trans,
            "relmax_fp32": worst["fp32"], "relmax_bf16": worst["bf16"],
            "max_abs_err_fp32": max_abs}


def cuda_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Median over `repeats` of the mean time of `reps` back-to-back calls,
    by CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Device time of one call of `fn`: `reps` calls captured in one CUDA
    graph after a warm call, the graph replayed `repeats` times between
    CUDA events, the median per call.  Unlike `cuda_ms` it leaves out the
    host's time to enqueue each call, which exceeds the device time of a
    small kernel."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kink_relmax(got, want, u, act) -> tuple[float, int]:
    """relmax of act'(u) against its plain version.  For relu and leaky the
    derivative steps at u = 0, and two summation orders may put a u within
    rounding of 0 on either side, so those are compared away from the kink
    (|u| > FP32_TOL * max|u|); also returns how many elements differed
    at the kink."""
    if act not in ("relu", "leaky"):
        return relmax(got, want), 0
    away = u.abs() > FP32_TOL * float(u.abs().max())
    return relmax(got[away], want[away]), int(((got != want) & ~away).sum())


def check_res_shape(m, k, n, plans, gen) -> dict:
    """The residual forward vs its plain version at one shape over dtypes,
    activations and epilogues; y must equal the serving launch's bits."""
    worst = {"fp32": 0.0, "bf16": 0.0}
    max_abs, kink = 0.0, 0
    for dt in (torch.float32, torch.bfloat16):
        kind = "fp32" if dt == torch.float32 else "bf16"
        tol = FP32_TOL if kind == "fp32" else BF16_TOL
        x, w, scale, shift = operands(m, k, n, dt, gen)
        acc = torch.matmul(x.float(), w.float())
        for act in ACTIVATIONS:
            for sc, sh in ((None, None), (scale, None), (None, shift),
                           (scale, shift)):
                u = epilogue(acc, sc, sh, "linear")
                want = gemm.gemm_fused_res_plain(x, w, sc, sh, act=act)
                for plan in plans:
                    got = gemm.gemm_fused_fwd(x, w, sc, sh, act=act,
                                              plan=plan, residuals=True)
                    serve = gemm.gemm_fused_fwd(x, w, sc, sh, act=act,
                                                plan=plan)
                    where = (f"{(m, k, n)} {dt} {act} scale={sc is not None}"
                             f" shift={sh is not None} plan={plan}")
                    check(torch.equal(got[0], serve),
                          f"residual y differs from the serving y at {where}")
                    check(all((a is None) == (b is None)
                              for a, b in zip(got, want)),
                          f"residuals present differ at {where}")
                    errs = [relmax(got[0], want[0])]
                    if got[1] is not None:
                        err, n_kink = kink_relmax(got[1], want[1], u, act)
                        errs.append(err)
                        kink += n_kink
                    if got[2] is not None:
                        errs.append(relmax(got[2], want[2]))
                    check(all(math.isfinite(e) for e in errs),
                          f"non-finite residual forward at {where}")
                    check(max(errs) <= tol, f"residual forward vs plain at "
                          f"{where}: {max(errs):.3e} > {tol:g}")
                    worst[kind] = max(worst[kind], max(errs))
                    if kind == "fp32":
                        max_abs = max(max_abs, float(
                            (got[0] - want[0]).abs().max()))
                        if got[2] is not None:
                            max_abs = max(max_abs, float(
                                (got[2] - want[2]).abs().max()))
    return {"kernel": "gemm_fused_fwd_res", "shape": [m, k, n],
            "plans": [list(p) for p in plans], "relmax_fp32": worst["fp32"],
            "relmax_bf16": worst["bf16"], "max_abs_err_fp32": max_abs,
            "g_differs_at_kink": kink}


def check_bwd_shape(m, k, n, dx_plans, dw_plans, gen,
                    long_k: bool = False) -> dict:
    """dX = dY W^T and dW = X^T dY vs their plain versions at the forward
    shape (m, k, n), over in/out dtypes and (plan, splits) pairs; a dW run
    twice must give the same bits.  With `long_k` the fp32 bar of a
    contraction past 4096 terms (dX's n, dW's m) grows with its square
    root (`gemm_tol`), as `lm_train_gemm_rows` holds the LM head."""
    worst = {"gemm_bwd_dx": {"fp32": 0.0, "bf16": 0.0},
             "gemm_bwd_dw": {"fp32": 0.0, "bf16": 0.0}}
    max_abs = {"gemm_bwd_dx": 0.0, "gemm_bwd_dw": 0.0}
    dev = gen.device
    for in_dt in (torch.float32, torch.bfloat16):
        x = torch.randn(m, k, generator=gen, device=dev).to(in_dt)
        w = (torch.randn(k, n, generator=gen, device=dev)
             / math.sqrt(n)).to(in_dt)
        dy = torch.randn(m, n, generator=gen, device=dev).to(in_dt)
        for out_dt in (torch.float32, torch.bfloat16):
            kind = "fp32" if in_dt == out_dt == torch.float32 else "bf16"
            for name, fn, plain, a, b, plans, kdim in (
                    ("gemm_bwd_dx", gemm.gemm_bwd_dx, gemm.gemm_bwd_dx_plain,
                     dy, w, dx_plans, n),
                    ("gemm_bwd_dw", gemm.gemm_bwd_dw, gemm.gemm_bwd_dw_plain,
                     x, dy, dw_plans, m)):
                tol = (BF16_TOL if kind == "bf16" else gemm_tol(kdim)
                       if long_k else FP32_TOL)
                want = plain(a, b, out_dtype=out_dt)
                for plan, splits in plans:
                    got = fn(a, b, out_dtype=out_dt, plan=plan, splits=splits)
                    where = (f"{name} at {(m, k, n)} {in_dt}->{out_dt} "
                             f"plan={tuple(plan)} splits={splits}")
                    check(bool(torch.isfinite(got).all()),
                          f"non-finite {where}")
                    err = relmax(got, want)
                    check(err <= tol, f"{where}: {err:.3e} > {tol:g}")
                    worst[name][kind] = max(worst[name][kind], err)
                    if kind == "fp32":
                        max_abs[name] = max(max_abs[name], float(
                            (got - want).abs().max()))
                    if name == "gemm_bwd_dw":
                        check(torch.equal(got, fn(a, b, out_dtype=out_dt,
                                                  plan=plan, splits=splits)),
                              f"two runs of {where} differ")
    return {"shape": [m, k, n], "dx_plans": dx_plans, "dw_plans": dw_plans,
            "dw_splits": [gemm.split_chunk(m, s)[1] for _, s in dw_plans],
            "relmax": worst, "max_abs_err_fp32": max_abs}


def bwd_plans(m, k, n) -> tuple[list, list]:
    """The path's (plan, splits) of the backward GEMMs of the forward GEMM
    (m, k, n)."""
    return [ops.bwd_plan("dx", m, n, k)], [ops.bwd_plan("dw", k, m, n)]


def check_bwd_bits(m, k, n, gen) -> dict:
    """At the forward shape (m, k, n), fp32 and bf16 in and out: every
    backward plan gives the bits of the path's plan, at the path's split,
    for dX = dY W^T (W row-major, and a tied head's W = E^T read in place)
    and both dW orientations (X^T dY, and the tied head's dE = dY^T X); and
    dX in one piece equals the forward kernel's dY @ W^T (linear, no scale
    or shift), bit for bit, for both layouts of W."""
    dev = gen.device
    cases = 0
    for in_dt in (torch.float32, torch.bfloat16):
        x = torch.randn(m, k, generator=gen, device=dev).to(in_dt)
        w = (torch.randn(k, n, generator=gen, device=dev)
             / math.sqrt(n)).to(in_dt)
        e = w.t().contiguous()  # (N, K), the table of a tied head
        dy = torch.randn(m, n, generator=gen, device=dev).to(in_dt)
        variants = (
            ("dx", gemm.gemm_bwd_dx, (dy, w), ops.bwd_plan("dx", m, n, k)),
            ("dx tied", gemm.gemm_bwd_dx, (dy, e.t()),
             ops.bwd_plan("dx", m, n, k)),
            ("dw", gemm.gemm_bwd_dw, (x, dy), ops.bwd_plan("dw", k, m, n)),
            ("dE", gemm.gemm_bwd_dw, (dy, x), ops.bwd_plan("dw", n, m, k)))
        for out_dt in (torch.float32, torch.bfloat16):
            for name, fn, args, (pick, splits) in variants:
                want = fn(*args, out_dtype=out_dt, plan=pick, splits=splits)
                for plan in gemm.BWD_PLANS:
                    check(torch.equal(fn(*args, out_dtype=out_dt, plan=plan,
                                         splits=splits), want),
                          f"{name} at {(m, k, n)} {in_dt}->{out_dt} splits="
                          f"{splits}: plan {tuple(plan)} differs from "
                          f"{tuple(pick)}")
                    cases += 1
            for wt, fwd_w in ((w, w.t()), (e.t(), e)):
                fwd = gemm.gemm_fused_fwd(dy, fwd_w, out_dtype=out_dt)
                for plan in gemm.BWD_PLANS:
                    check(torch.equal(gemm.gemm_bwd_dx(
                        dy, wt, out_dtype=out_dt, plan=plan, splits=1), fwd),
                          f"dX in one piece at {(m, k, n)} {in_dt}->{out_dt} "
                          f"plan {tuple(plan)} is not the forward's dY W^T")
                    cases += 1
                del fwd
        del x, w, e, dy
    return {"shape": [m, k, n], "plans": [list(p) for p in gemm.BWD_PLANS],
            "bitwise_cases": cases}


def grads_of(net, batch) -> tuple[torch.Tensor, dict]:
    """cnn_loss_fn and its gradient with respect to every parameter."""
    params = dict(net.named_parameters())
    loss = cnn_loss_fn(net, *batch)
    return loss, dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


def host_ms(fn, reps: int = 5) -> float:
    """Median host time of `fn()` followed by a device synchronise, after
    one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def all_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel name, and the `cuda`
    SSD dispatches that took the einsum form under grad."""
    return {**gemm.launch_counts(), **fa.launch_counts(),
            "flash_decode": fd.launches, "ssd_scan": ssd.launches,
            "ssd_einsum_form": ssd.einsum_dispatches,
            "conv2d_direct": conv_direct.launches}


def reset_all_launches() -> None:
    """Set every launch count and the engine's dispatch counts to 0."""
    gemm.reset_launches()
    fa.reset_launches()
    fd.reset_launches()
    ssd.reset_launches()
    conv_direct.reset_launches()
    backends.reset_dispatch_counts()


def drift(run: dict, ref: dict) -> dict:
    """Loss, parameter and moment distance of a training `run` from `ref`
    (each ``{"losses", "params", "state"}``, parameters and moments keyed
    by name)."""
    return {"loss": [abs(a - b) / abs(b)
                     for a, b in zip(run["losses"], ref["losses"])],
            "params": {k: relmax(run["params"][k], p)
                       for k, p in ref["params"].items()},
            "moments": {f"{m}.{k}": relmax(run["state"][m][k],
                                           ref["state"][m][k])
                        for m in ("mu", "nu") for k in ref["params"]}}


def bound(flops, nbytes, peak_flops, peak_bw) -> tuple[float, str]:
    """(least ms, what bounds it) for `flops` FFMA-rate operations and
    `nbytes` moved once each."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


# ----------------------------------------------------------------- the LM ---

def qkv(b, sq, skv, h, kv, d, dtype, gen):
    """Attention operands drawn on the card from the CUDA generator `gen`."""
    dev = gen.device
    q = torch.randn(b, sq, h, d, generator=gen, device=dev) / math.sqrt(d)
    k = torch.randn(b, skv, kv, d, generator=gen, device=dev)
    v = torch.randn(b, skv, kv, d, generator=gen, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def live_mask(q, k, kv_len, causal) -> torch.Tensor:
    """(B, Sq, Skv) bool: the (query, key) pairs the attention reads."""
    b, sq = q.shape[:2]
    return attention_mask(b, sq, k.shape[1], causal=causal, kv_len=kv_len,
                          device=q.device).expand(b, sq, k.shape[1])


def attn_work(q, k, kv_len, causal, out_bytes) -> tuple[float, float]:
    """(FLOPs, bytes) these inputs need: 4 D FLOPs per live (query row,
    key) pair and query head; q, each live key's k and v row once, and the
    output once."""
    _, _, h, d = q.shape
    mask = live_mask(q, k, kv_len, causal)
    keys = float(mask.any(1).sum())            # live key rows, all batches
    flops = 4.0 * d * h * float(mask.sum())
    nbytes = q.element_size() * (q.numel() + 2.0 * keys * k.shape[2] * d)
    return flops, nbytes + out_bytes


def check_attn_plans(q, k, v, kvl, causal, got, where) -> int:
    """Every forward plan the head dim admits (`fa.plans_at`), with and
    without lse, against the path plan's outputs at one case, bit for bit;
    a plan it does not admit must be refused with ValueError before any
    launch.  Returns the outputs compared."""
    o_lse, lse = fa.flash_attention_fwd(q, k, v, kvl, causal=causal,
                                        return_lse=True)
    check(torch.equal(o_lse, got), f"the lse launch's o differs at {where}")
    plans = fa.plans_at(q.shape[-1])
    for plan in set(fa.PLANS) - set(plans):
        before = fa.launch_counts()
        try:
            fa.flash_attention_fwd(q, k, v, kvl, causal=causal, plan=plan)
        except ValueError:
            pass
        else:
            raise RuntimeError(f"plan {plan} was not refused at {where}")
        check(fa.launch_counts() == before, f"a refused plan launched at "
              f"{where}")
    for plan in plans:
        o = fa.flash_attention_fwd(q, k, v, kvl, causal=causal, plan=plan)
        o2, lse2 = fa.flash_attention_fwd(q, k, v, kvl, causal=causal,
                                          return_lse=True, plan=plan)
        check(torch.equal(o, got) and torch.equal(o2, got)
              and torch.equal(lse2, lse),
              f"forward plan {plan} differs from the path plan's bits at "
              f"{where}")
    return 3 * len(plans)


def check_attn_case(q, k, v, kvl, causal) -> tuple[float, float, int]:
    """Forward kernel vs plain at one case: (max-relative, max-abs error,
    outputs compared bitwise across plans); rows with no live key must
    come out exactly 0, every plan must give the path plan's bits."""
    got = fa.flash_attention_fwd(q, k, v, kvl, causal=causal)
    want = fa.flash_attention_plain(q, k, v, kvl, causal=causal)
    where = f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} causal={causal}"
    check(bool(torch.isfinite(got).all()), f"non-finite attention at {where}")
    dead = ~live_mask(q, k, kvl, causal).any(-1)          # (B, Sq)
    check(bool((got[dead] == 0).all()), f"dead rows not 0 at {where}")
    err = relmax(got, want)
    check(err <= (FP32_TOL if q.dtype == torch.float32 else BF16_TOL),
          f"flash_attention vs plain at {where}: {err:.3e}")
    bits = check_attn_plans(q, k, v, kvl, causal, got, where)
    return err, float((got.float() - want.float()).abs().max()), bits


def check_decode_case(q, k, v, kvl, causal) -> tuple[float, float, int,
                                                     int, float]:
    """Decode partials vs plain at one case, the empty-span sentinels, the
    launch with the merge (its partials bitwise the partials-only
    launch's, its output bitwise `combine`'s), and at one split the
    forward kernel's bits: (max-relative, max-abs error, splits, outputs
    compared bitwise, the merge's max-abs difference from `combine`)."""
    skv = k.shape[1]
    n_splits, span = ops.decode_splits(skv, k.shape[2])
    got = fd.flash_decode_partials(q, k, v, kvl, causal=causal,
                                   n_splits=n_splits, span=span)
    want = fd.flash_decode_plain(q, k, v, kvl, causal=causal,
                                 n_splits=n_splits, span=span)
    where = (f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} causal="
             f"{causal} splits={n_splits}x{span}")
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"non-finite partials at {where}")
    check(torch.equal(got[1] == fd.EMPTY_SPAN_LSE,
                      want[1] == fd.EMPTY_SPAN_LSE),
          f"empty spans differ at {where}")
    check(bool((got[0][got[1] == fd.EMPTY_SPAN_LSE] == 0).all()),
          f"an empty span's partial is not 0 at {where}")
    err = max(relmax(got[0], want[0]), relmax(got[1], want[1]))
    check(err <= (FP32_TOL if q.dtype == torch.float32 else BF16_TOL),
          f"flash_decode vs plain at {where}: {err:.3e}")
    merged, o_part, lse_part = fd.flash_decode(q, k, v, kvl, causal=causal,
                                               n_splits=n_splits, span=span)
    check(torch.equal(o_part, got[0]) and torch.equal(lse_part, got[1]),
          f"the merging launch's partials differ at {where}")
    plain_merge = fd.merge_plain(*got, q.dtype)
    check(torch.equal(merged, plain_merge),
          f"the merge is not combine's bits at {where}")
    merge_abs = float((merged.float() - plain_merge.float()).abs().max())
    one, _ = fd.flash_decode_partials(q, k, v, kvl, causal=causal,
                                      n_splits=1, span=-(-skv // 64) * 64)
    fwd = fa.flash_attention_fwd(q, k, v, kvl, causal=causal)
    check(torch.equal(one[:, :, 0].transpose(1, 2).to(q.dtype), fwd),
          f"one-split decode is not the forward kernel's bits at {where}")
    return (err, float((got[0] - want[0]).abs().max()), n_splits, 3,
            merge_abs)


def refused(calls: dict) -> list[str]:
    """On the card: each of `calls` ({name: (call, head dim)}) must raise
    ValueError naming its head dim, with no launch.  Returns the calls
    refused."""
    before = all_launches()
    out = []
    for name, (call, d) in calls.items():
        try:
            call()
        except ValueError as e:
            check(f"head dim {d}" in str(e), f"{name}: {e}")
            out.append(name)
        else:
            raise RuntimeError(f"{name} was not refused at head dim {d}")
    torch.cuda.synchronize()
    check(all_launches() == before, "a refused head dim launched a kernel")
    return out


def zero_operands(d, sq=4, h=4, skv=64, kv=4):
    """Zero q (2, sq, h, d), k (2, skv, kv, d) and an lse (2, h, sq) on the
    card, for a call that must be refused (no draw from a generator)."""
    dev = torch.device("cuda", 0)
    return (torch.zeros(2, sq, h, d, device=dev),
            torch.zeros(2, skv, kv, d, device=dev),
            torch.zeros(2, h, sq, device=dev))


def bwd_refusals(d) -> dict:
    """dQ, dK / dV and `FlashAttention` at head dim `d`, for `refused`."""
    q, k, lse = zero_operands(d)
    return {f"flash_attention_bwd_dq at {d}": (
                lambda: fa.flash_attention_bwd_dq(q, k, k, q, lse, lse), d),
            f"flash_attention_bwd_dkv at {d}": (
                lambda: fa.flash_attention_bwd_dkv(q, k, k, q, lse, lse), d),
            f"FlashAttention at {d}": (
                lambda: fa.FlashAttention.apply(q.requires_grad_(), k, k,
                                                None, True), d)}


def refused_head_dims(cgen) -> list[str]:
    """On the card, at head dim 80: the decode kernel and the forward's
    32-lane plan must each be refused (`refused`).  The operands are drawn
    from `cgen` as before the backward took 80, so every later draw stays
    as it was."""
    q, k, v = qkv(2, 4, 256, 4, 2, 80, torch.float32, cgen)
    kvl = torch.tensor([256, 100], dtype=torch.int32, device=cgen.device)
    return refused({
        "flash_attention_fwd plan (8, 256, 32)": (lambda: (
            fa.flash_attention_fwd(q, k, v, kvl, plan=fa.PLANS[2])), 80),
        "flash_decode": (lambda: fd.flash_decode(
            q, k, v, kvl, causal=False, n_splits=4, span=64), 80),
        "flash_decode_partials": (lambda: fd.flash_decode_partials(
            q, k, v, kvl, causal=False, n_splits=4, span=64), 80)})


def refused_at_112() -> dict:
    """At zamba2's head dim 112 the forward's 32-lane plan, for
    `refused`."""
    q, k, _ = zero_operands(112)
    return {"flash_attention_fwd plan (8, 256, 32)": (
        lambda: fa.flash_attention_fwd(q, k, k, plan=fa.PLANS[2]), 112)}


# Head dims added to check_attn's grid after 32 / 64 / 80 / 128 draw their
# operands from a generator of their own (seeded with the head dim), so
# the grid's other draws, and every error printed after them, stay those
# of the runs before the addition.
NEW_HEAD_DIMS = (112, 192, 576)


def attn_phases(cgen) -> dict:
    """Phases check_attn and check_decode; returns the fp32 max-abs errors
    at qwen2-0.5b's shapes.  The grid's worst errors are reported for the
    head dims 32 / 64 / 80 / 128 and, apart, for each later one
    (`NEW_HEAD_DIMS`)."""
    worst = {"attn": {"fp32": 0.0, "bf16": 0.0},
             "decode": {"fp32": 0.0, "bf16": 0.0}}
    path_abs = {"attn": 0.0, "decode": 0.0, "merge": 0.0}
    dev = cgen.device
    new = {d: ({"attn": {"fp32": 0.0, "bf16": 0.0},
                "decode": {"fp32": 0.0, "bf16": 0.0}},
               torch.Generator(device=dev).manual_seed(d))
           for d in NEW_HEAD_DIMS}
    cases = bits = dec_bits = 0
    for h, kv in HEAD_RATIOS:
        for d in fa.FWD_HEAD_DIMS:
            dworst, gen = new.get(d, (worst, cgen))
            for dt in (torch.float32, torch.bfloat16):
                kind = "fp32" if dt == torch.float32 else "bf16"
                for sq in (1, 4, 16):
                    for skv in (64, 256):
                        q, k, v = qkv(2, sq, skv, h, kv, d, dt, gen)
                        kvl = torch.tensor([skv // 2 + 3, 0],
                                           dtype=torch.int32, device=dev)
                        for causal in (True, False):
                            for lens in (None, kvl):
                                err, _, n = check_attn_case(q, k, v, lens,
                                                            causal)
                                bits += n
                                dworst["attn"][kind] = max(
                                    dworst["attn"][kind], err)
                                cases += 1
                if d not in fd.HEAD_DIMS:  # the decode kernel: 32/64/112/128
                    continue
                for sq in (1, 4, 8):
                    for skv in (256, 1024):
                        q, k, v = qkv(3, sq, skv, h, kv, d, dt, gen)
                        kvl = torch.tensor([skv, skv // 3, 0],
                                           dtype=torch.int32, device=dev)
                        for causal in (True, False):
                            err, _, _, n, _ = check_decode_case(q, k, v, kvl,
                                                                causal)
                            dec_bits += n
                            dworst["decode"][kind] = max(
                                dworst["decode"][kind], err)
    torch.cuda.synchronize()
    refused_80 = refused_head_dims(cgen)
    emit("check_attn", grid_cases=cases, relmax=worst["attn"],
         head_dims=list(fa.FWD_HEAD_DIMS),
         plans={d: [list(p) for p in fa.plans_at(d)]
                for d in fa.FWD_HEAD_DIMS},
         plan_outputs_bitwise=bits, refused_at_80=refused_80,
         refused_at_112=refused(refused_at_112()),
         relmax_new_head_dims={d: w["attn"] for d, (w, _) in new.items()},
         decode_relmax_new_head_dims={d: w["decode"]
                                      for d, (w, _) in new.items()
                                      if d in fd.HEAD_DIMS})
    cfg = get_arch(LM_ARCH)
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = []
    bits = 0
    for name, (b, sq, skv, lens, causal) in {
            "prefill_chunk": (1, 64, LM_CACHE, [576], True),
            "prefill_chunk_b4": (4, 64, LM_CACHE, [576, 300, 900, 64], True),
            "prompt_512": (1, LM_PREFILL, LM_PREFILL, None, True),
            "training": (LM_TRAIN["batch"], LM_TRAIN["seq"], LM_TRAIN["seq"],
                         None, True),
            "shallow_decode": (8, 1, 128, [1, 17, 40, 64, 80, 100, 127, 128],
                               False)}.items():
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(b, sq, skv, h, kv, d, dt, cgen)
            kvl = (None if lens is None else
                   torch.tensor(lens, dtype=torch.int32, device=dev))
            err, mabs, n = check_attn_case(q, k, v, kvl, causal)
            bits += n
            if dt == torch.float32:
                path_abs["attn"] = max(path_abs["attn"], mabs)
            rows.append({"shape": name, "dtype": str(dt), "relmax": err,
                         "max_abs": mabs,
                         "plan": list(fa.plan_for(b, sq, h, kv, d))})
    emit("check_attn", arch=LM_ARCH, cases=rows, plan_outputs_bitwise=bits)
    rows = []
    for name, (b, sq, skv, lens, causal) in {
            "decode_b8": (8, 1, LM_CACHE, [1024, 700, 300, 256, 129, 65, 1,
                                           0], False),
            "decode_b1": (1, 1, LM_CACHE, [913], False),
            "chunk_8": (1, 8, 512, [400], True)}.items():
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(b, sq, skv, h, kv, d, dt, cgen)
            kvl = torch.tensor(lens, dtype=torch.int32, device=dev)
            err, mabs, splits, n, merr = check_decode_case(q, k, v, kvl,
                                                           causal)
            dec_bits += n
            if dt == torch.float32:
                path_abs["decode"] = max(path_abs["decode"], mabs)
                path_abs["merge"] = max(path_abs["merge"], merr)
            rows.append({"shape": name, "dtype": str(dt), "splits": splits,
                         "relmax": err, "max_abs": mabs})
    torch.cuda.synchronize()
    emit("check_decode", relmax=worst["decode"], arch=LM_ARCH, cases=rows,
         bitwise_one_split=True, merge_outputs_bitwise=dec_bits,
         merge_max_abs=path_abs["merge"])
    return path_abs


def lm_gemms(cfg) -> list[dict]:
    """The GEMMs one dispatch of the dense LM makes: each layer's seven
    projections and the tied head, with name, (K, N), fused epilogue (the
    QKV bias is the shift; SwiGLU's gate fuses silu), launches per
    dispatch and whether w is read transposed (the head, from the (V, D)
    embedding table)."""
    d, q = cfg.d_model, cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    layer = [("q", d, q, "linear", cfg.qkv_bias),
             ("k", d, kv, "linear", cfg.qkv_bias),
             ("v", d, kv, "linear", cfg.qkv_bias),
             ("o", q, d, "linear", False),
             ("gate", d, cfg.d_ff, "silu", False),
             ("up", d, cfg.d_ff, "linear", False),
             ("down", cfg.d_ff, d, "linear", False)]
    out = [{"name": name, "k": k, "n": n, "act": act, "shift": shift,
            "per_dispatch": cfg.n_layers, "trans": False}
           for name, k, n, act, shift in layer]
    return out + [{"name": "head", "k": d, "n": cfg.vocab_padded,
                   "act": "linear", "shift": False, "per_dispatch": 1,
                   "trans": cfg.tie_embeddings}]


def ssm_gemms(cfg) -> list[dict]:
    """The GEMMs of one mamba2 forward, as `lm_gemms`: each layer's wz,
    wx, wB, wC, wdt and out projections (no epilogue; dt in fp32) and the
    tied head."""
    d, di = cfg.d_model, cfg.ssm_d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    layer = [("wz", d, di), ("wx", d, di), ("wB", d, gn), ("wC", d, gn),
             ("wdt", d, cfg.ssm_nheads), ("out", di, d)]
    out = [{"name": name, "k": k, "n": n, "act": "linear", "shift": False,
            "per_dispatch": cfg.n_layers, "trans": False}
           for name, k, n in layer]
    return out + [{"name": "head", "k": d, "n": cfg.vocab_padded,
                   "act": "linear", "shift": False, "per_dispatch": 1,
                   "trans": cfg.tie_embeddings}]


def regimes_phase(cgen) -> None:
    """Phase check_regimes: at every GEMM shape of qwen2-0.5b and
    mamba2-1.3b, M in REGIME_ROWS, fp32 and bf16 operands, every plan of
    both regimes gives the bits of the path's plan (y, and with residuals
    g and racc at fp32); the transposed heads read in place."""
    seen = set()
    for arch, gemms in ((LM_ARCH, lm_gemms(get_arch(LM_ARCH))),
                        (SSM_ARCH, ssm_gemms(get_arch(SSM_ARCH)))):
        rows = []
        for g in gemms:
            for m in REGIME_ROWS:
                k, n, trans = g["k"], g["n"], g["trans"]
                key = (m, k, n, g["act"], g["shift"], trans)
                if key in seen:
                    continue
                seen.add(key)
                pick = ops.default_tiles(m, k, n)
                for dt in (torch.float32, torch.bfloat16):
                    x, w, scale, shift = operands(m, k, n, dt, cgen, trans)
                    sh = shift if g["shift"] else None
                    res = dt == torch.float32
                    sc = scale if res else None
                    def run(plan):  # (y, g, racc), the residuals at fp32
                        out = gemm.gemm_fused_fwd(x, w, sc, sh, act=g["act"],
                                                  plan=plan, residuals=res)
                        return out if res else (out,)

                    want = run(pick)
                    for plan in gemm.PLANS:
                        check(all(a is None and b is None or torch.equal(a, b)
                                  for a, b in zip(run(plan), want)),
                              f"{arch} {g['name']} {(m, k, n)} {dt}: plan "
                              f"{plan} differs from {pick}")
                    del x, w
                rows.append([g["name"], m, k, n, list(pick)])
        emit("check_regimes", arch=arch, plans=[list(p) for p in gemm.PLANS],
             bitwise_cases=rows)
    torch.cuda.synchronize()


def regime_counts(fn) -> dict:
    """The forward GEMM's launches by regime during one call of `fn`."""
    torch.cuda.synchronize()
    gemm.reset_launches()
    fn()
    torch.cuda.synchronize()
    counts = gemm.launch_counts()
    return {"A": counts["gemm_fwd_regime_a"],
            "B": counts["gemm_fwd_regime_b"]}


def figure3_phase(gen, peak_flops, peak_bw, smi) -> dict:
    """Phase timing_figure3: the paper's Figure 3 GEMM (M 2048, K 4096,
    N 16384, fp32, no epilogue) through the path's plan, checked against
    its plain version (FP32_TOL), and timed: kernel, plain, torch.matmul
    (cuBLAS fp32, TF32 off) and bound ms, TFLOP/s, bound share."""
    m, k, n = FIGURE3
    x, w, _, _ = operands(m, k, n, torch.float32, gen)
    plan = ops.default_tiles(m, k, n)
    got = gemm.gemm_fused_fwd(x, w, plan=plan)
    err = relmax(got, gemm.gemm_fused_plain(x, w))
    check(bool(torch.isfinite(got).all()) and err <= gemm_tol(k),
          f"the Figure 3 GEMM vs plain: {err:.3e}")
    del got
    flops = 2.0 * m * k * n
    nbytes = 4.0 * (m * k + k * n + m * n)
    row = {"ms": cuda_ms(lambda: gemm.gemm_fused_fwd(x, w, plan=plan),
                         reps=5, repeats=3),
           "plain_ms": cuda_ms(lambda: gemm.gemm_fused_plain(x, w), reps=5,
                               repeats=3),
           "library_ms": cuda_ms(lambda: torch.matmul(x, w), reps=5,
                                 repeats=3),
           "ops_ms": flops / peak_flops * 1e3,
           "bytes_ms": nbytes / peak_bw * 1e3}
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes, peak_flops,
                                             peak_bw)
    row.update(tflops=flops / row["ms"] / 1e9,
               library_tflops=flops / row["library_ms"] / 1e9,
               bound_share=row["bound_ms"] / row["ms"], relmax=err)
    emit("timing_figure3", smi=smi, shape=[m, k, n], plan=list(plan), **row)
    del x, w
    return row


def lm_gemm_check(cfg, cgen) -> float:
    """Phase check_lm_gemm: the fused GEMM against its plain version at
    the LM's shapes, M 1, 8 and 64 (a decode row, a batch-8 decode, a
    64-token prefill chunk) with the path's tile, every epilogue and
    dtype as phase 2, the head reading w transposed; returns the fp32
    max-abs error."""
    max_abs, seen = 0.0, set()
    for m in LM_GEMM_ROWS:
        for g in lm_gemms(cfg):
            key = (m, g["k"], g["n"], g["trans"])
            if key in seen:             # q / o and k / v share a shape
                continue
            seen.add(key)
            plans = (ops.default_tiles(m, g["k"], g["n"]),)
            res = check_shape(m, g["k"], g["n"], plans, cgen, g["trans"])
            max_abs = max(max_abs, res["max_abs_err_fp32"])
            emit("check_lm_gemm", arch=LM_ARCH, m=m, gemm=g["name"], **res)
    torch.cuda.synchronize()
    return max_abs


def lm_gemm_timing(cfg, cgen, peak_flops, peak_bw, smi,
                   rows=LM_GEMM_ROWS, phase="timing_lm_gemm") -> dict:
    """Phase timing_lm_gemm: each LM GEMM at M 1, 8 and 64 (`rows`), fp32
    with its epilogue: the kernel, its plain version and torch.matmul (cuBLAS fp32,
    TF32 off, no epilogue), each the device time of CUDA-graph replays,
    and the bound.  As on the path, each timed call runs the GEMM once
    per layer over that many distinct weights, so the weights come from
    device memory and not from the 50 MB L2.  Sums per dispatch (24
    layers x 7 + the head) at each M, and their total over the three."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms",
            "bytes_ms")
    total = dict.fromkeys(keys, 0.0)
    per_m = {}
    for m in rows:
        disp = dict.fromkeys(keys, 0.0)
        for g in lm_gemms(cfg):
            k, n, reps = g["k"], g["n"], g["per_dispatch"]
            x, w, _, shift = operands(m, k, n, torch.float32, cgen,
                                      g["trans"])
            ws = [w] + [w.clone() for _ in range(reps - 1)]
            sh = shift if g["shift"] else None
            act = g["act"]
            plan = ops.default_tiles(m, k, n)
            flops = 2.0 * m * k * n
            nbytes = 4.0 * (m * k + k * n + m * n + (n if g["shift"] else 0))

            def each(fn):
                return graph_ms(lambda: [fn(wi) for wi in ws],
                                reps=max(1, 20 // reps)) / reps

            row = {"ms": each(lambda wi: gemm.gemm_fused_fwd(
                       x, wi, None, sh, act=act, plan=plan)),
                   "plain_ms": each(lambda wi: gemm.gemm_fused_plain(
                       x, wi, None, sh, act=act)),
                   "library_ms": each(lambda wi: torch.matmul(x, wi)),
                   "ops_ms": flops / peak_flops * 1e3,
                   "bytes_ms": nbytes / peak_bw * 1e3}
            row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
            emit(phase, m=m, gemm=g["name"], shape=[m, k, n],
                 act=act, shift=g["shift"], trans_w=g["trans"],
                 plan=list(plan),
                 per_dispatch=reps, **row,
                 bound_by=("operations" if row["ops_ms"] >= row["bytes_ms"]
                           else "bytes"), bound_share=row["bound_ms"]
                 / row["ms"])
            for key in keys:
                disp[key] += reps * row[key]
            del x, w, ws
        per_m[str(m)] = disp
        for key in keys:
            total[key] += disp[key]
    emit(f"{phase}_total", smi=smi, per_dispatch=per_m,
         launches_per_dispatch=sum(g["per_dispatch"] for g in lm_gemms(cfg)),
         **total)
    return total


def lm_params(cfg, dev):
    """Full-width random parameters from seed 4, with random QKV biases
    (the init's zeros would leave the bias epilogue untested); the ranks of
    phase 64 make the same (`mesh_checks.random_lm_params`)."""
    return mesh_checks.random_lm_params(cfg, dev, 4)


def lm_phase(cfg, params, dev) -> dict:
    """Phase lm: cuda vs eager at full width; returns the logits error."""
    cuda, eager = make_engine("cuda"), make_engine("eager", device=dev)
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, LM_PREFILL))).to(dev)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 1))).to(dev)
    head = tfm.head_weight(params, cfg)
    table = params["embed"]["tokens"]
    out = {}
    with torch.inference_mode():
        for label, eng in (("cuda", cuda), ("eager", eager)):
            before = (fa.launches, fd.launches)
            logits, caches = make_prefill_step(eng, cfg)(
                params, {"tokens": tokens})
            buf = kvcache.cache_init(cfg, 1, LM_CACHE, device=dev)
            kvcache.copy_prefill(cfg, buf, caches, LM_PREFILL)
            step = make_decode_step(eng, cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            dlogits, _ = step(params, buf, nxt,
                              torch.tensor(LM_PREFILL, device=dev))
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated(dev) - base
            out[label] = {"logits": logits, "caches": caches,
                          "dlogits": dlogits, "decode_extra_bytes": extra,
                          "launches": (fa.launches - before[0],
                                       fd.launches - before[1])}
    cu, ea = out["cuda"], out["eager"]
    errs = {"prefill_logits": relmax(cu["logits"], ea["logits"]),
            "k_cache": relmax(cu["caches"][0]["k"], ea["caches"][0]["k"]),
            "v_cache": relmax(cu["caches"][0]["v"], ea["caches"][0]["v"]),
            "decode_logits": relmax(cu["dlogits"], ea["dlogits"])}
    abs_err = max(float((cu[k] - ea[k]).abs().max())
                  for k in ("logits", "dlogits"))
    head_bytes = head.numel() * head.element_size()
    emit("lm", arch=LM_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
         prefill=LM_PREFILL, cache_rows=LM_CACHE, relmax=errs,
         logits_max_abs_err=abs_err,
         logits_max_abs=float(ea["logits"].abs().max()),
         launches_cuda={"flash_attention": cu["launches"][0],
                        "flash_decode": cu["launches"][1]},
         launches_eager=ea["launches"],
         decode_extra_mb=cu["decode_extra_bytes"] / 1e6,
         head_mb=head_bytes / 1e6)
    for key, err in errs.items():
        check(math.isfinite(err) and err <= LOGIT_TOL,
              f"{key} cuda vs eager {err:.3e} > {LOGIT_TOL:g}")
    check(cu["launches"] == (cfg.n_layers, cfg.n_layers),
          f"lm launches {cu['launches']}, want one of each per layer")
    check(ea["launches"] == (0, 0), "the eager engine launched a kernel")
    check(gemm.is_transposed(head) and head.data_ptr() == table.data_ptr()
          and tfm.head_weight(params, cfg).data_ptr() == table.data_ptr()
          and table.is_contiguous() and set(params) == {
              "embed", "final_norm", "layers"},
          "the tied head is not the embedding table read in place")
    check(cu["decode_extra_bytes"] < head_bytes,
          f"a decode dispatch allocated {cu['decode_extra_bytes']} bytes, "
          f"as much as the head: it was copied")
    return {"abs_err": abs_err, "errs": errs}


def bucket_phase(cfg, params, dev) -> dict:
    """A sequence's decode logits in batch bucket 1 and in bucket 8 (the
    other rows padded as the scheduler pads them) must be bitwise equal:
    a 300-token sequence against 320 and 512 gathered rows (the decode
    formulation) and a 100-token one against 128 (the forward kernel)."""
    step = make_paged_step(make_engine("cuda"), cfg)
    cache = kvpool.PagedKVCache(cfg, 64, 16, device=dev)
    rng = np.random.default_rng(8)
    chunk = SERVE["chunk"]
    seqs = {300: np.arange(0, 32, dtype=np.int32),
            100: np.arange(40, 48, dtype=np.int32)}
    result = {}
    with torch.inference_mode():
        for n, table in seqs.items():            # prefill, chunk by chunk
            prompt = rng.integers(1, cfg.vocab_size, n)
            rows = -(-n // chunk) * chunk // 16
            for c0 in range(0, n, chunk):
                toks = np.zeros((1, chunk), np.int64)
                part = prompt[c0:c0 + chunk]
                toks[0, :len(part)] = part
                step(params, cache.pools, table[None, :rows], toks,
                     np.array([c0], np.int32))
        for n, nb in ((300, 20), (300, 32), (100, 8)):
            runs = []
            for bb in (1, 8):
                tables = np.full((bb, nb), cache.trash_block, np.int32)
                tables[0] = seqs[n][:nb]
                toks = np.zeros((bb, 1), np.int64)
                toks[0, 0] = 7
                pos = np.zeros(bb, np.int32)
                pos[0] = n
                pools = [{k: t.clone() for k, t in e.items()}
                         for e in cache.pools]
                logits, _ = step(params, pools, tables, toks, pos)
                runs.append(logits[:1])
            torch.cuda.synchronize()
            result[str(nb * 16)] = bool(torch.equal(runs[0], runs[1]))
    emit("lm_bucket", bitwise=result,
         formulation={r: ("decode" if ops.use_decode_formulation(1, int(r))
                          else "forward") for r in result})
    check(all(result.values()), f"bucket 1 and 8 logits differ: {result}")
    return result


def requests(cfg, n, seed, prompt, new) -> list:
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        1, cfg.vocab_size, int(rng.integers(prompt[0], prompt[1] + 1))
    ).tolist(), max_new=int(rng.integers(new[0], new[1] + 1)))
        for i in range(n)]


def lm_serve_phase(cfg, params, dev, abs_err) -> dict:
    """Phase lm_serve: the LM main path, then the slot engine."""
    cuda, eager = make_engine("cuda"), make_engine("eager", device=dev)
    server = PagedServingEngine(cfg, params, engine=cuda, **SERVE)
    reqs = requests(cfg, N_REQUESTS, 6, (8, 700), (4, 48))
    reset_all_launches()
    t0 = time.perf_counter()
    server.run(reqs)  # ---- the main path, driven once
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = gemm.launch_counts()
    launches = {"gemm_fused_fwd": gemm.launches,
                "gemm_fwd_regime_a": counts["gemm_fwd_regime_a"],
                "gemm_fwd_regime_b": counts["gemm_fwd_regime_b"],
                "flash_attention": fa.launches, "flash_decode": fd.launches}
    dispatch = backends.dispatch_counts()
    st = server.stats()
    comp = st["compile"]
    emit("lm_serve", requests=N_REQUESTS,
         completed=st["requests"]["completed"],
         rejected=st["requests"]["rejected"], tokens=st["tokens"],
         prompt_tokens=sum(len(r.prompt) for r in reqs), steps=st["steps"],
         wall_s=wall, tokens_per_s=st["throughput"],
         p50_ms=st["latency_s"]["p50"] * 1e3,
         p99_ms=st["latency_s"]["p99"] * 1e3, builds=comp["traces"],
         trace_bound=st["trace_bound"], calls=comp["calls"],
         dispatches={str(k): v for k, v in comp["dispatches"].items()},
         peak_active=st["peak_active"], pool=st["pool"], launches=launches,
         engine_dispatch={f"{b}.{o}": c for (b, o), c in dispatch.items()})
    check(st["requests"]["completed"] == N_REQUESTS
          and st["requests"]["rejected"] == 0
          and all(r.done and len(r.out) == r.max_new for r in reqs),
          f"{st['requests']['completed']} of {N_REQUESTS} completed")
    check(comp["traces"] <= st["trace_bound"],
          f"{comp['traces']} builds > bound {st['trace_bound']}")
    check(launches["flash_attention"] > 0 and launches["flash_decode"] > 0
          and launches["gemm_fused_fwd"] > 0,
          f"the main path skipped a kernel: {launches}")
    # every dispatch holds at most 64 rows (a 64-token chunk or a decode
    # batch), so every GEMM of the path runs in regime A
    check(launches["gemm_fwd_regime_a"] == launches["gemm_fused_fwd"]
          and launches["gemm_fwd_regime_b"] == 0,
          f"LM serving GEMMs outside regime A: {launches}")
    check(all(b == "cuda" for b, _ in dispatch),
          f"an engine op left the cuda backend: {dispatch}")
    check(any(nb * SERVE["block_size"] >= ops.DECODE_MIN_SKV and bb > 1
              for bb, cc, nb in comp["dispatches"] if cc == 1),
          "no batched decode dispatch reached the decode formulation")

    # the slot engine on a smaller stream, against the paged engine
    small = [requests(cfg, 6, 7, (8, 40), (4, 12)) for _ in range(2)]
    PagedServingEngine(cfg, params, engine=cuda, **SERVE).run(small[0])
    ServingEngine(cfg, params, engine=cuda, slots=4, max_len=256).run(
        small[1])
    mismatches = []
    head = tfm.head_weight(params, cfg)
    for a, b in zip(*small):
        check(a.done and b.done, "a small-stream request did not complete")
        if a.out == b.out:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a.out, b.out)) if x != y)
        with torch.inference_mode():
            h, _ = tfm.forward_hidden(eager, cfg, params, tokens=torch.tensor(
                [a.prompt + a.out[:j]], device=dev))
            top2 = torch.topk(h[0, -1] @ head, 2).values
        margin = float(top2[0] - top2[1])
        mismatches.append({"rid": a.rid, "token": j, "eager_margin": margin,
                           "allowed_below": MARGIN_FACTOR * abs_err})
    emit("lm_slot", requests=len(small[0]),
         tokens=sum(len(r.out) for r in small[0]), mismatches=mismatches,
         n_mismatches=len(mismatches))
    check(all(m["eager_margin"] < m["allowed_below"] for m in mismatches),
          f"slot vs paged token mismatch at a clear margin: {mismatches}")
    return {"launches": launches, "stats": st, "wall_s": wall}


def sdpa(q, k, v, kv_len, causal):
    """torch's scaled_dot_product_attention on the same problem (the
    library baseline; the port never calls it)."""
    mask = live_mask(q, k, kv_len, causal)[:, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)


def attn_timing_rows(cfg, shapes, cgen, peak_flops, peak_bw, smi,
                     phase) -> dict:
    """Each attention kernel at `shapes` ({name: (b, sq, skv, kv_len list
    or None, causal)}) at cfg's heads, fp32: kernel, plain, bound and
    SDPA ms over CUDA-graph replays, emitted as `phase` lines."""
    dev = cgen.device
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = {}
    for name, (b, sq, skv, lens, causal) in shapes.items():
        q, k, v = qkv(b, sq, skv, h, kv, d, torch.float32, cgen)
        kvl = (None if lens is None else
               torch.tensor(lens, dtype=torch.int32, device=dev))
        if ops.use_decode_formulation(sq, skv):
            ns, span = ops.decode_splits(skv, kv)

            def fn():  # the path's launch: partials and their merge
                return fd.flash_decode(q, k, v, kvl, causal=causal,
                                       n_splits=ns, span=span)

            def plain():
                return fd.merge_plain(*fd.flash_decode_plain(
                    q, k, v, kvl, causal=causal, n_splits=ns, span=span),
                    q.dtype)

            kernel = "flash_decode"
            # the merged output, written once; the fp32 partials are the
            # split design's scratch, not the function's output
            out_bytes = float(q.element_size() * q.numel())
            parts = fd.flash_decode_partials(q, k, v, kvl, causal=causal,
                                             n_splits=ns, span=span)
            # op_ms: the whole function on the path, which is what
            # library_ms (one SDPA call) computes: here one launch
            extra = {"splits": ns, "span": span,
                     "partials_ms": graph_ms(
                         lambda: fd.flash_decode_partials(
                             q, k, v, kvl, causal=causal, n_splits=ns,
                             span=span)),
                     "combine_ms": graph_ms(
                         lambda: fd.merge_plain(*parts, q.dtype))}
        else:
            kernel, fn, plain = "flash_attention", (
                lambda: fa.flash_attention_fwd(q, k, v, kvl, causal=causal)), (
                lambda: fa.flash_attention_plain(q, k, v, kvl, causal=causal))
            out_bytes = 4.0 * q.numel()
            extra = {"plan": list(fa.plan_for(b, sq, h, kv, d)),
                     "plans_ms": {str(tuple(p)): graph_ms(
                         lambda p=p: fa.flash_attention_fwd(
                             q, k, v, kvl, causal=causal, plan=p))
                         for p in fa.plans_at(d)}}
        flops, nbytes = attn_work(q, k, kvl, causal, out_bytes)
        bound_ms, bound_by = bound(flops, nbytes, peak_flops, peak_bw)
        ms = graph_ms(fn)
        if kernel == "flash_decode":
            extra["op_ms"] = ms
        row = {"kernel": kernel, "shape": [b, sq, skv, h, kv, d],
               "causal": causal, "ms": ms, "enqueued_ms": cuda_ms(fn),
               "plain_ms": graph_ms(plain),
               "library_ms": graph_ms(lambda: sdpa(q, k, v, kvl, causal)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "ops_ms": flops / peak_flops * 1e3,
               "bytes_ms": nbytes / peak_bw * 1e3,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "bound_share": bound_ms / ms, **extra}
        rows[name] = row
        emit(phase, name=name, smi=smi, **row)
        del q, k, v
    return rows


def timing_lm_phase(cfg, params, dev, cgen, peak_flops, peak_bw,
                    serve: dict, smi: str) -> dict:
    """Phase timing_lm: the attention kernels at the path's shapes and the
    paged step's dispatch times."""
    rows = attn_timing_rows(cfg, {
        "prefill_chunk": (1, 64, LM_CACHE, [576], True),
        "prompt_2048": (1, 2048, 2048, None, True),
        "decode_b8": (8, 1, LM_CACHE, [LM_CACHE] * 8, False),
        "decode_b1": (1, 1, LM_CACHE, [LM_CACHE], False)}, cgen,
        peak_flops, peak_bw, smi, "timing_lm")
    step = make_paged_step(make_engine("cuda"), cfg)
    cache = kvpool.PagedKVCache(cfg, SERVE["kv_blocks"], SERVE["block_size"],
                                device=dev)
    chunk = SERVE["chunk"]
    dispatch = {}
    with torch.inference_mode():
        for name, (bb, c, nb, pos) in {
                "prefill_chunk_b1_nb64": (1, chunk, 64, 512),
                "decode_b1_nb32": (1, 1, 32, 400),
                "decode_b8_nb32": (8, 1, 32, 400),
                "decode_b8_nb8": (8, 1, 8, 100)}.items():
            tables = np.arange(bb * nb, dtype=np.int32).reshape(bb, nb)
            toks = np.ones((bb, c), np.int64)
            posv = np.full(bb, pos, np.int32)
            ms = host_ms(lambda: step(params, cache.pools, tables, toks,
                                      posv))
            dispatch[name] = {"ms": ms, "tokens_per_s": bb * c / ms * 1e3}
    st = serve["stats"]
    emit("timing_lm_step", smi=smi, dispatch=dispatch,
         serve_tokens_per_s=st["throughput"],
         p50_ms=st["latency_s"]["p50"] * 1e3,
         p99_ms=st["latency_s"]["p99"] * 1e3)
    return rows


# ------------------------------------------------------ serving on a mesh ---

def sharded_cases(cfg) -> list[dict]:
    """Phase 63's cases (`mesh_checks.check_ops`) at cfg's widths: the
    decode step's GEMMs at 4 slots and a 64-token prefill chunk's, the
    tied head read transposed, a bmm of 4, DARKNET19's 3 x 3 conv of 64 to
    128 channels at 56 x 56 and batch 2, attention batch-sharded (decode
    at 4 slots, a prefill chunk at 2), head-sharded on ("model",) and
    sequence-split (3 rows against 512 keys), and the partials at
    relative extents.  `bits`: held bit for bit to the local launch."""
    d, dq, ff = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff
    dkv = cfg.n_kv_heads * cfg.head_dim
    heads = dict(h=cfg.n_heads, kv=cfg.n_kv_heads, d=cfg.head_dim)
    data, model = ((SHARD_WORLD,), ("data",)), ((SHARD_WORLD,), ("model",))
    cases = [dict(name=f"{name}_{m}", op="matmul", m=m, k=k, n=n, act=act,
                  shift=shift, mesh=data, bits=True)
             for m in (4, 64)
             for name, k, n, act, shift in (("q", d, dq, "linear", True),
                                             ("k", d, dkv, "linear", True),
                                             ("gate", d, ff, "silu", False),
                                             ("down", ff, d, "linear", False))]
    cases += [
        dict(name="head_4", op="matmul", m=4, k=d, n=cfg.vocab_padded,
             trans=True, mesh=data, bits=True),
        dict(name="bmm", op="bmm", b=4, m=16, k=d, n=dkv, mesh=data,
             bits=True),
        dict(name="darknet19_conv", op="conv2d", b=2, h=56, w=56, cin=64,
             cout=128, size=3, pad=1, act="leaky", scale=True, shift=True,
             mesh=data, bits=True),
        dict(name="attn_decode_batch", op="attention", b=4, sq=1, skv=256,
             causal=True, kv_len=[256, 100, 1, 37], mesh=data, bits=True,
             **heads),
        dict(name="attn_prefill_batch", op="attention", b=2, sq=64, skv=128,
             causal=True, kv_len=[128, 64], mesh=data, bits=True, **heads),
        dict(name="attn_decode_heads", op="attention", b=4, sq=1, skv=512,
             causal=True, kv_len=[512, 300, 2, 77], mesh=model, **heads),
        dict(name="attn_prefill_heads", op="attention", b=1, sq=64, skv=128,
             causal=True, kv_len=[128], mesh=model, **heads)]
    cases += [dict(name=f"attn_seq_sq{sq}_{'none' if lens is None else 'lens'}",
                   op="attention", b=3, sq=sq, skv=512, causal=True,
                   kv_len=lens, mesh=data, **heads)
              for sq in (1, 4) for lens in (None, [3, 300, 512])]
    cases += [dict(name=f"partial_sq{sq}", op="partial", b=3, sq=sq,
                   skv=256, causal=causal, kv_len=lens, mesh=None, **heads)
              for sq, causal, lens in ((1, True, [300, -5, 256]),
                                       (4, True, [259, 2, 0]),
                                       (8, False, [3, 0, 400]),
                                       (8, True, [260, 5, -300]))]
    return cases


def sharded_kernel(case: dict) -> str:
    """The kernel a case's shards launch."""
    if case["op"] in ("matmul", "conv2d"):
        return "gemm_fused_fwd"
    if case["op"] == "bmm":
        return "bmm_fwd"
    if case["op"] == "partial" or case["name"].startswith("attn_seq"):
        return "flash_attention_lse"
    return ("flash_decode" if ops.use_decode_formulation(
        case["sq"], case["skv"]) else "flash_attention")


def check_sharded_phase(cfg) -> dict:
    """Phase check_sharded (63): see the module docstring.  Returns the
    largest kernel vs plain errors of the GEMM, the split-KV decode and
    the lse forward cases, for the kernels line."""
    torch.cuda.empty_cache()
    cases = sharded_cases(cfg)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = mesh.spawn(mesh_checks.check_ops, SHARD_WORLD, "cuda", cases,
                           SHARD_SEED, device_type="cuda",
                           store_path=Path(tmp) / "store", timeout=600)
    wall = time.perf_counter() - t0
    want_path = {"matmul": "matmul_rows", "conv2d": "matmul_rows",
                 "bmm": "bmm_batch"}
    errs = collections.defaultdict(float)
    for case, res in zip(cases, ranks[0]):
        emit("check_sharded", **{k: v for k, v in res.items() if k != "keys"},
             plan_keys=res["keys"], kernel=sharded_kernel(case))
        kernel, path = sharded_kernel(case), None
        check(res["launches"].get(kernel, 0) >= 1,
              f"check_sharded {case['name']}: {kernel} not launched: "
              f"{res['launches']}")
        if case["op"] == "partial":
            check(res["sentinel_exact"] and res["sentinel_rows"] > 0,
                  f"check_sharded {case['name']}: sentinel rows differ")
        else:
            path = want_path.get(case["op"]) or (
                "attention_seq" if case["name"].startswith("attn_seq") else
                "attention_heads" if case["mesh"][1] == ("model",) else
                "attention_batch")
            col = res["collectives"]
            check(list(res["paths"]) == [path],
                  f"check_sharded {case['name']}: paths {res['paths']}")
            check(col["all_gather"] == col["to_host"] == col["to_device"]
                  == 1, f"check_sharded {case['name']}: collectives {col}")
        if path == "attention_seq":
            check(res["loop_bitwise"], f"check_sharded {case['name']}: the "
                  f"split differs from the loop of partials and combine")
        kdim = (case["size"] ** 2 * case["cin"] if case["op"] == "conv2d"
                else case.get("k"))
        tol = gemm_tol(kdim) if kdim else FP32_TOL
        if case.get("bits"):
            check(res["bitwise"], f"check_sharded {case['name']}: not "
                  f"bitwise the local launch ({res['max_abs_err']:.3e})")
        check(res["relmax"] <= FP32_TOL, f"check_sharded {case['name']}: "
              f"{res['relmax']:.3e} from the local launch")
        check(res["plain_relmax"] <= tol, f"check_sharded {case['name']}: "
              f"{res['plain_relmax']:.3e} from the plain version")
        errs[kernel] = max(errs[kernel], res["plain_max_abs_err"])
    check(ranks[0] == ranks[1], "check_sharded: the ranks' results differ")
    emit("check_sharded_total", ranks=SHARD_WORLD, cases=len(cases),
         wall_s=wall, max_abs_err=dict(errs))
    return dict(errs)


def sharded_serve_runs(cfg) -> list[dict]:
    """Phase 64's runs, each on the same SHARDED_SERVE stream."""
    rng = np.random.default_rng(SHARDED_SERVE["seed"])
    lo, hi = SHARDED_SERVE["prompt"]
    reqs = [(rng.integers(1, cfg.vocab_size, int(rng.integers(lo, hi + 1))
                          ).tolist(),
             int(rng.integers(SHARDED_SERVE["new"][0],
                              SHARDED_SERVE["new"][1] + 1)))
            for _ in range(SHARDED_SERVE["requests"])]
    data, model = ((SHARD_WORLD,), ("data",)), ((SHARD_WORLD,), ("model",))
    return [
        dict(name="slot_batch", engine="slot", mesh=data,
             kwargs=dict(slots=4, max_len=256), requests=reqs,
             paths=("matmul_rows", "attention_batch"),
             kernels=("gemm_fused_fwd", "flash_decode")),
        dict(name="slot_seq", engine="slot", mesh=data,
             kwargs=dict(slots=3, max_len=512), requests=reqs,
             paths=("attention_seq",),
             kernels=("gemm_fused_fwd", "flash_attention_lse")),
        dict(name="slot_heads", engine="slot", mesh=model, strategy="tp",
             kwargs=dict(slots=4, max_len=256), requests=reqs,
             paths=("attention_heads",),
             kernels=("gemm_fused_fwd", "flash_decode")),
        dict(name="paged", engine="paged", mesh=data,
             kwargs=dict(kv_blocks=128, block_size=16, max_len=512,
                         chunk=64, prefill_budget=256), requests=reqs,
             paths=("matmul_rows", "attention_batch"),
             kernels=("gemm_fused_fwd", "flash_attention"))]


def sharded_serve_phase(cfg, abs_err, smi) -> dict:
    """Phase sharded_serve (64): see the module docstring.  Returns rank
    0's runs by name."""
    torch.cuda.empty_cache()
    runs = sharded_serve_runs(cfg)
    spec = dict(arch=cfg.name, seed=4, reference="cuda",
                runs=[{k: v for k, v in r.items()
                       if k not in ("paths", "kernels")} for r in runs])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = mesh.spawn(mesh_checks.serve_streams, SHARD_WORLD, "cuda",
                           spec, device_type="cuda",
                           store_path=Path(tmp) / "store", timeout=900)
    wall = time.perf_counter() - t0
    sums = ranks[0]["checksums"]
    check(len(set(sums)) == 1 and ranks[1]["checksums"] == sums,
          f"sharded_serve: the ranks' parameter checksums differ: {sums}")
    refs = {r["name"]: r for r in ranks[0]["reference"]}
    for run in runs:
        name = run["name"]
        got = [{r["name"]: r for r in rank["runs"]}[name] for rank in ranks]
        ref = refs[name]
        for rank, g in enumerate(got):
            col = g["collectives"]
            emit("sharded_serve", run=name, rank=rank, engine=run["engine"],
                 mesh=g["mesh"], steps=g["steps"], wall_s=g["wall_s"],
                 ms_per_step=g["ms_per_step"],
                 unsharded_ms_per_step=ref["ms_per_step"],
                 note="both ranks share one card", launches=g["launches"],
                 paths=g["paths"], collectives=col,
                 collectives_per_step=col["all_gather"] / max(1, g["steps"]),
                 host_staged_copies=col["to_host"] + col["to_device"],
                 dispatch=g["dispatch"],
                 equal_to_unsharded=[a == b for a, b in zip(
                     g["streams"], ref["streams"])],
                 mismatches=ref["mismatches"] if rank == 0 else [],
                 allowed_below=MARGIN_FACTOR * abs_err, smi=smi)
            check(g["done"], f"sharded_serve {name}: a request did not "
                  f"complete on rank {rank}")
            check(g["streams"] == got[0]["streams"],
                  f"sharded_serve {name}: the ranks' streams differ")
            check(all(k.startswith("sharded_cuda.") for k in g["dispatch"]),
                  f"sharded_serve {name}: a dispatch left sharded_cuda: "
                  f"{g['dispatch']}")
            check(all(g["paths"].get(p, 0) > 0 for p in run["paths"]),
                  f"sharded_serve {name}: paths {g['paths']}")
            check(all(g["launches"].get(k, 0) > 0 for k in run["kernels"]),
                  f"sharded_serve {name}: a kernel of the path did not "
                  f"launch: {g['launches']}")
            check(col["to_host"] == col["to_device"] == col["all_gather"],
                  f"sharded_serve {name}: a gather was not staged: {col}")
            check(g["mesh"] == [[run["mesh"][1][0], SHARD_WORLD]],
                  f"sharded_serve {name}: mesh {g['mesh']}")
        check(all(m["margin"] < MARGIN_FACTOR * abs_err
                  for m in ref["mismatches"]),
              f"sharded_serve {name}: a stream differs from the unsharded "
              f"engine at a clear margin: {ref['mismatches']}")
    emit("sharded_serve_total", runs=len(runs), wall_s=wall, smi=smi)
    return {r["name"]: r for r in ranks[0]["runs"]}


def timing_sharded_phase(cfg, dev, peak_flops, peak_bw, smi) -> dict:
    """Phase timing_sharded (65): the kernels at the shards' shapes on
    SHARD_SEED's generator: the decode GEMMs at M 2 (`lm_gemm_timing`),
    the split-KV decode of 2 rows against 256 (`attn_timing_rows`) and
    the lse forward of both ranks' spans of 3 rows against 512 keys at
    kv_len 3 / 300 / 512 (no single PyTorch call gives the lse)."""
    sgen = torch.Generator(device=dev).manual_seed(SHARD_SEED)
    gemm_row = lm_gemm_timing(cfg, sgen, peak_flops, peak_bw, smi,
                              rows=(4 // SHARD_WORLD,),
                              phase="timing_sharded_gemm")
    decode_row = attn_timing_rows(
        cfg, {"sharded_decode": (4 // SHARD_WORLD, 1, 256, [256, 101],
                                 True)},
        sgen, peak_flops, peak_bw, smi, "timing_sharded")["sharded_decode"]
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = qkv(3, 1, 512, h, kv, d, torch.float32, sgen)
    qs = ops.scale_queries(q)
    lens = torch.tensor([3, 300, 512], dtype=torch.int32, device=dev)
    spans = [(k[:, i * 256:(i + 1) * 256], v[:, i * 256:(i + 1) * 256],
              (lens - i * 256).contiguous()) for i in range(SHARD_WORLD)]
    plan = fa.plan_for(3, 1, h, kv, d)
    flops = nbytes = 0.0
    for ks, vs, kvl in spans:
        live = attention_mask(3, 1, 256, causal=True, kv_len=kvl,
                              device=dev, relative=True).expand(3, 1, 256)
        flops += 4.0 * d * h * float(live.sum())
        nbytes += 4.0 * (2 * q.numel() + 2.0 * float(live.any(1).sum()) * kv
                         * d + 3 * h)
    bound_ms, bound_by = bound(flops, nbytes, peak_flops, peak_bw)
    lse_row = {
        "ms": graph_ms(lambda: [fa.flash_attention_fwd(
            qs, ks, vs, kvl, causal=True, return_lse=True, plan=plan,
            relative=True) for ks, vs, kvl in spans]),
        "plain_ms": graph_ms(lambda: [fa.flash_attention_plain(
            qs, ks, vs, kvl, causal=True, return_lse=True, relative=True)
            for ks, vs, kvl in spans]),
        "library_ms": None, "bound_ms": bound_ms,
        "ops_ms": flops / peak_flops * 1e3,
        "bytes_ms": nbytes / peak_bw * 1e3}
    emit("timing_sharded", name="sharded_seq_partials", kernel=
         "flash_attention_lse", shape=[3, 1, 256, h, kv, d], spans=2,
         kv_len=[3, 300, 512], plan=list(plan), bound_by=bound_by,
         bound_share=bound_ms / lse_row["ms"], smi=smi, **lse_row)
    return {"gemm": gemm_row, "decode": decode_row, "lse": lse_row}


# ---------------------------------------------------------- LM training ---

def check_attn_bwd_case(q, k, v, kvl, causal, gen) -> tuple[dict, dict]:
    """The lse forward and both backward kernels vs their plain versions at
    one case: (max-relative errors, fp32 max-abs errors) by output.  The
    lse launch must keep the serving launch's o, dead rows and keys must
    get exactly 0, each kernel run twice the same bits, and dQ under every
    plan the head dim admits (fa.bwd_plans_at: 16- and 64-row blocks, so
    two grids in two orders; at 192 the 16-row plan alone) the path plan's
    bits."""
    where = f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} causal={causal}"
    args = dict(causal=causal)
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, kvl, return_lse=True, **args)
    check(torch.equal(o, fa.flash_attention_fwd(q, k, v, kvl, **args)),
          f"the lse launch changes o's bits at {where}")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta, kvl)
    dq = fa.flash_attention_bwd_dq(*bwd, **args)
    dk, dv = fa.flash_attention_bwd_dkv(*bwd, **args)
    wo, wlse = fa.flash_attention_plain(q, k, v, kvl, return_lse=True,
                                        **args)
    want = {"o": wo, "lse": wlse,
            "dq": fa.flash_attention_bwd_dq_plain(*bwd, **args)}
    want["dk"], want["dv"] = fa.flash_attention_bwd_dkv_plain(*bwd, **args)
    got = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    check(all(bool(torch.isfinite(t).all()) for t in got.values()),
          f"non-finite attention backward at {where}")
    errs = {key: relmax(got[key], want[key]) for key in got}
    tol = FP32_TOL if q.dtype == torch.float32 else BF16_TOL
    check(max(errs.values()) <= tol,
          f"attention backward vs plain at {where}: {errs}")
    live = live_mask(q, k, kvl, causal)
    dead_rows, dead_keys = ~live.any(-1), ~live.any(1)
    check(bool((dq[dead_rows] == 0).all() and (dk[dead_keys] == 0).all()
               and (dv[dead_keys] == 0).all()
               and (lse.transpose(1, 2)[dead_rows] == 0).all()),
          f"dead rows or keys not exactly 0 at {where}")
    again = fa.flash_attention_bwd_dkv(*bwd, **args)
    check(torch.equal(dq, fa.flash_attention_bwd_dq(*bwd, **args))
          and torch.equal(dk, again[0]) and torch.equal(dv, again[1]),
          f"two runs of the backward kernels differ at {where}")
    for plan in fa.bwd_plans_at(q.shape[-1]):
        check(torch.equal(dq, fa.flash_attention_bwd_dq(*bwd, plan=plan,
                                                        **args)),
              f"dQ plan {plan} changes the bits at {where}")
    max_abs = {key: float((got[key].float() - want[key].float()).abs().max())
               for key in got}
    return errs, max_abs


def attn_bwd_phase(cgen) -> dict:
    """Phase check_attn_bwd; returns the fp32 max-abs errors at the
    training shape by output."""
    worst = {"fp32": 0.0, "bf16": 0.0}
    cases = 0
    dev = cgen.device
    for h, kv in HEAD_RATIOS:
        for d in (32, 64, 128):
            for dt in (torch.float32, torch.bfloat16):
                kind = "fp32" if dt == torch.float32 else "bf16"
                for sq, skv in BWD_SHAPES:
                    q, k, v = qkv(2, sq, skv, h, kv, d, dt, cgen)
                    kvl = torch.tensor([skv // 2 + 3, 0], dtype=torch.int32,
                                       device=dev)
                    for causal in (True, False):
                        for lens in (None, kvl):
                            errs, _ = check_attn_bwd_case(q, k, v, lens,
                                                          causal, cgen)
                            worst[kind] = max(worst[kind],
                                              max(errs.values()))
                            cases += 1
    torch.cuda.synchronize()
    emit("check_attn_bwd", grid_cases=cases, relmax=worst,
         plans_bitwise=[list(p) for p in fa.BWD_PLANS])
    cfg = get_arch(LM_ARCH)
    b, s = LM_TRAIN["batch"], LM_TRAIN["seq"]
    rows, path_abs = [], {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = qkv(b, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dt,
                      cgen)
        errs, mabs = check_attn_bwd_case(q, k, v, None, True, cgen)
        if dt == torch.float32:
            path_abs = mabs
        rows.append({"dtype": str(dt), "relmax": errs, "max_abs": mabs})
        del q, k, v
    torch.cuda.synchronize()
    emit("check_attn_bwd", arch=LM_ARCH, shape=[b, s, s, cfg.n_heads,
                                                cfg.n_kv_heads, cfg.head_dim],
         causal=True, cases=rows, bitwise_two_runs=True,
         path_plan=list(fa.bwd_plan_for(b, s, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim)),
         plans_bitwise=[list(p) for p in fa.bwd_plans_at(cfg.head_dim)])
    return path_abs


def lm_train_params(cfg, dev, seed):
    """`train_loop`'s parameters: `init_params` from a CUDA generator
    seeded with `seed`."""
    return tfm.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)


def lm_train_batch(cfg, dev, step, batch, seq, seed):
    """`train_loop`'s batch of `step`, on the card."""
    data = SyntheticLM(cfg, ShapeConfig("train", seq, batch, "train"),
                       seed=seed)
    return {k: torch.from_numpy(a).to(dev) for k, a in
            data.batch(step).items()}


def lm_grads(engine, cfg, params, batch) -> tuple[torch.Tensor, dict]:
    """loss_fn (remat, ce_chunk as train_loop) and its gradient with
    respect to every parameter, by flat name (0 for a parameter the loss
    does not read, as the train step: an audio config's token table)."""
    leaves = {k: p.detach().requires_grad_()
              for k, p in flatten(params).items()}
    loss = tfm.loss_fn(engine, cfg, unflatten_like(leaves, params), batch,
                       remat=True, ce_chunk=min(512, batch["labels"].shape[1]))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(leaves.items(), grads)}


def head_copy_check(cfg, params, dev) -> dict:
    """The tied head under grad reads the embedding in place: the head
    GEMM's forward allocates its output and less than half a table more,
    its backward dE and dX and less than half a table more."""
    table = params["embed"]["tokens"]
    m = LM_TRAIN["batch"] * LM_TRAIN["seq"]
    e = table.detach().requires_grad_()
    x = torch.randn(m, cfg.d_model, device=dev, requires_grad=True)
    e_bytes = table.numel() * table.element_size()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    y = ops.matmul(x, e.t(), out_dtype=torch.float32)
    torch.cuda.synchronize()
    fwd = torch.cuda.max_memory_allocated(dev) - base
    dy = torch.ones_like(y)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    dx, de = torch.autograd.grad(y, (x, e), dy)
    torch.cuda.synchronize()
    bwd = torch.cuda.max_memory_allocated(dev) - base
    y_bytes = y.numel() * 4
    out = {"fwd_extra_mb": (fwd - y_bytes) / 1e6,
           "bwd_extra_mb": (bwd - de.numel() * 4 - dx.numel() * 4) / 1e6,
           "table_mb": e_bytes / 1e6}
    check(fwd < y_bytes + e_bytes / 2 and
          bwd < (de.numel() + dx.numel()) * 4 + e_bytes / 2,
          f"the tied head was copied under grad: {out}")
    return out


def lm_train_phase(cfg, dev) -> dict:
    """Phase lm_train (see the module docstring); returns the cuda run's
    launch counts."""
    seed, b, s = LM_TRAIN["seed"], LM_TRAIN["batch"], LM_TRAIN["seq"]
    engines = {"cuda": make_engine("cuda"),
               "eager": make_engine("eager", device=dev),
               "floor": make_engine(FLOOR_BACKEND, device=dev)}
    params = lm_train_params(cfg, dev, seed)
    head = tfm.head_weight(params, cfg)
    check(gemm.is_transposed(head) and head.data_ptr()
          == params["embed"]["tokens"].data_ptr(),
          "the tied head is not the embedding table's transpose")
    head_mem = head_copy_check(cfg, params, dev)
    n_leaves = len(flatten(params))
    batch0 = lm_train_batch(cfg, dev, 0, b, s, seed)
    loss_c, grads_c = lm_grads(engines["cuda"], cfg, params, batch0)
    loss_c2, grads_c2 = lm_grads(engines["cuda"], cfg, params, batch0)
    bitwise = torch.equal(loss_c, loss_c2) and all(
        torch.equal(g, grads_c2[k]) for k, g in grads_c.items())
    del grads_c2
    loss_e, grads_e = lm_grads(engines["eager"], cfg, params, batch0)
    grad_err = {k: relmax(g, grads_e[k]) for k, g in grads_c.items()}
    grad_abs = max(float((g - grads_e[k]).abs().max())
                   for k, g in grads_c.items())
    del grads_c
    loss_f, grads_f = lm_grads(engines["floor"], cfg, params, batch0)
    grad_floor = {k: relmax(g, grads_e[k]) for k, g in grads_f.items()}
    del grads_f, grads_e, params
    torch.cuda.empty_cache()
    step1 = {"loss_rel_err": abs(loss_c.item() - loss_e.item())
             / abs(loss_e.item()),
             "loss_rel_floor": abs(loss_f.item() - loss_e.item())
             / abs(loss_e.item())}

    runs = {}
    want = family_train_launches(cfg, b, s)
    for label in ("cuda", "eager", "floor"):
        metrics: list = []
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        p, st = train_loop(cfg, steps=LM_TRAIN["steps"], batch=b, seq=s,
                           ckpt_dir="", seed=seed, engine=engines[label],
                           metrics_out=metrics, log_every=1)  # main path
        torch.cuda.synchronize()
        runs[label] = {"params": flatten(p), "state": st,
                       "losses": [m["loss"] for m in metrics],
                       "wall_s": time.perf_counter() - t0,
                       "launches": all_launches(),
                       "dispatch": backends.dispatch_counts()}
    cu, ea, fl = runs["cuda"], runs["eager"], runs["floor"]
    err, floor = drift(cu, ea), drift(fl, ea)
    worst = {key: max(err[key].values()) for key in ("params", "moments")}
    worst_floor = {key: max(floor[key].values())
                   for key in ("params", "moments")}
    steps = LM_TRAIN["steps"]
    want_total = {k: steps * v for k, v in want.items()}
    emit("lm_train", arch=LM_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
         batch=b, seq=s, steps=steps, floor_backend=FLOOR_BACKEND,
         losses_cuda=cu["losses"], losses_eager=ea["losses"],
         losses_floor=fl["losses"], loss_rel_err=err["loss"],
         loss_rel_floor=floor["loss"], step1=step1,
         step1_grads_bitwise_two_runs=bitwise,
         grad_relmax_worst=max(grad_err.values()),
         grad_floor_worst=max(grad_floor.values()),
         grad_max_abs_err=grad_abs,
         param_relmax_worst=worst["params"],
         param_floor_worst=worst_floor["params"],
         moment_relmax_worst=worst["moments"],
         moment_floor_worst=worst_floor["moments"],
         floor_factor=FLOOR_FACTOR, launches=cu["launches"],
         want_launches=want_total, head_memory=head_mem,
         wall_s={k: r["wall_s"] for k, r in runs.items()},
         dispatch={f"{bk}.{o}": c for (bk, o), c in cu["dispatch"].items()},
         eager_launches=sum(ea["launches"].values()),
         grad_relmax=grad_err)
    check(all(math.isfinite(x) for x in cu["losses"]), "non-finite loss")
    check(bitwise, "two cuda runs of the step-1 gradients differ")
    check(step1["loss_rel_err"] <= FP32_TOL,
          f"step-1 loss cuda vs eager {step1['loss_rel_err']:.3e}")
    check(err["loss"][0] <= FP32_TOL,
          f"train_loop step-1 loss cuda vs eager {err['loss'][0]:.3e}")
    check(len(grad_err) == n_leaves,
          f"{len(grad_err)} gradients, want {n_leaves}")
    check(max(grad_err.values()) <= TRAIN_TOL,
          f"step-1 gradient cuda vs eager {max(grad_err.values()):.3e}")
    for i, (e, f) in enumerate(zip(err["loss"], floor["loss"])):
        check(e <= max(FP32_TOL, FLOOR_FACTOR * f),
              f"step-{i + 1} loss cuda vs eager {e:.3e}, "
              f"{FLOOR_BACKEND} vs eager {f:.3e}")
    for key in ("params", "moments"):
        check(worst[key] <= max(TRAIN_TOL, FLOOR_FACTOR * worst_floor[key]),
              f"{key} after {steps} steps: cuda vs eager {worst[key]:.3e}, "
              f"{FLOOR_BACKEND} vs eager {worst_floor[key]:.3e}")
    check(cu["launches"] == want_total,
          f"lm_train launches {cu['launches']}, want {want_total}")
    check(set(cu["dispatch"]) == {("cuda", "matmul"), ("cuda", "attention")},
          f"an engine op left the cuda backend: {cu['dispatch']}")
    check(sum(ea["launches"].values()) + sum(fl["launches"].values()) == 0,
          "the eager or floor engine launched a kernel of the port")
    return cu["launches"]


def lm_restart_phase(dev) -> None:
    """Phase lm_train_restart (see the module docstring)."""
    cfg = reduced(get_arch(LM_ARCH))
    root = build.BUILD_DIR / "lm_train_restart"
    shutil.rmtree(root, ignore_errors=True)
    args = dict(RESTART, log_every=100, engine=make_engine("cuda"))
    ref: list = []
    p_ref, s_ref = train_loop(cfg, ckpt_dir=str(root / "a"), metrics_out=ref,
                              **args)
    got: list = []
    try:
        train_loop(cfg, ckpt_dir=str(root / "b"), fail_at_step=RESTART_FAIL_AT,
                   metrics_out=got, **args)
        crashed = False
    except FailureInjected:
        crashed = True
    p_got, s_got = train_loop(cfg, ckpt_dir=str(root / "b"), metrics_out=got,
                              **args)
    shutil.rmtree(root, ignore_errors=True)
    losses = {m["step"]: m["loss"] for m in ref}
    again = {m["step"]: m["loss"] for m in got}
    flat_ref, flat_got = flatten((p_ref, s_ref)), flatten((p_got, s_got))
    bitwise = set(flat_ref) == set(flat_got) and all(
        torch.equal(v, flat_got[k]) if isinstance(v, torch.Tensor)
        else v == flat_got[k] for k, v in flat_ref.items())
    emit("lm_train_restart", arch=cfg.name, **RESTART,
         fail_at_step=RESTART_FAIL_AT, crashed=crashed,
         losses=[losses[i] for i in sorted(losses)],
         losses_after_restart=[again[i] for i in sorted(again)],
         bitwise=bitwise, leaves=len(flat_ref))
    check(crashed, "the injected failure did not fire")
    check(again == losses, "losses differ after the restart")
    check(bitwise, "parameters or moments differ after the restart")


def attn_train_rows(shape, cgen, peak_flops, peak_bw) -> dict:
    """The lse forward and the dQ and dK / dV kernels at a training shape
    (b, s, h, kv, d, causal), drawn from `cgen`: kernel, plain, bound and
    library ms (CUDA-graph replays;
    library: SDPA's forward and its autograd backward by CUDA events, each
    the fastest of the boolean mask with enable_gqa, is_causal on repeated
    K / V where causal, and, for the backward, no mask where not,
    `time_attention.sdpa_fwd_ms` / `sdpa_bwd_ms`, which time the repeat,
    and the group sum of the backward, with it); the lse
    forward and dQ also under every plan the head dim admits
    (`plans_ms`: `plans_at`, `bwd_plans_at`)."""
    b, s, h, kv, d, causal = shape
    q, k, v = qkv(b, s, s, h, kv, d, torch.float32, cgen)
    do = torch.randn(q.shape, generator=cgen, device=q.device)
    o, lse = fa.flash_attention_fwd(q, k, v, None, causal=causal,
                                    return_lse=True)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta, None)
    live = live_mask(q, k, None, causal)
    pairs = float(live.sum()) * h
    f4 = 4.0 * q.numel() + 2.0 * 4.0 * k.numel()       # q, k, v once
    rowb = 2 * 4.0 * b * h * s                         # lse and delta
    work = {"flash_attention_lse": (4 * d * pairs, f4 + 4.0 * q.numel()
                                    + 4.0 * b * h * s),
            "flash_attention_bwd_dq": (6 * d * pairs, f4 + 8.0 * q.numel()
                                       + rowb),
            "flash_attention_bwd_dkv": (8 * d * pairs, f4 + 4.0 * q.numel()
                                        + rowb + 8.0 * k.numel())}
    sdpa_bwd = time_attention.sdpa_bwd_ms(q, k, v, do, live, causal)
    sdpa_fwd = time_attention.sdpa_fwd_ms(q, k, v, live, causal)
    fns = {"flash_attention_lse": (
               lambda: fa.flash_attention_fwd(q, k, v, None, causal=causal,
                                              return_lse=True),
               lambda: fa.flash_attention_plain(q, k, v, None, causal=causal,
                                                return_lse=True),
               sdpa_fwd["library"]),
           "flash_attention_bwd_dq": (
               lambda: fa.flash_attention_bwd_dq(*bwd, causal=causal),
               lambda: fa.flash_attention_bwd_dq_plain(*bwd, causal=causal),
               sdpa_bwd["library"]),
           "flash_attention_bwd_dkv": (
               lambda: fa.flash_attention_bwd_dkv(*bwd, causal=causal),
               lambda: fa.flash_attention_bwd_dkv_plain(*bwd, causal=causal),
               sdpa_bwd["library"])}

    def whole_bwd():
        dl = (do * o).sum(-1).transpose(1, 2).contiguous()
        fa.flash_attention_bwd_dq(q, k, v, do, lse, dl, causal=causal)
        fa.flash_attention_bwd_dkv(q, k, v, do, lse, dl, causal=causal)

    op_ms = graph_ms(whole_bwd)
    rows = {}
    for name, (fn, plain, library) in fns.items():
        flops, nbytes = work[name]
        bound_ms, bound_by = bound(flops, nbytes, peak_flops, peak_bw)
        ms = graph_ms(fn)
        rows[name] = {"ms": ms, "plain_ms": graph_ms(plain),
                      "library_ms": library, "bound_ms": bound_ms,
                      "bound_by": bound_by,
                      "ops_ms": flops / peak_flops * 1e3,
                      "bytes_ms": nbytes / peak_bw * 1e3,
                      "gflop": flops / 1e9, "bound_share": bound_ms / ms}
        if name != "flash_attention_lse":
            rows[name].update(op_ms=op_ms, **{
                f"sdpa_{key}_ms": ms for key, ms in sdpa_bwd.items()
                if key != "library"})
    rows["flash_attention_lse"].update(
        **{f"sdpa_{key}_ms": ms for key, ms in sdpa_fwd.items()
           if key != "library"},
        plan=list(fa.plan_for(b, s, h, kv, d)),
        plans_ms={str(tuple(p)): graph_ms(
            lambda p=p: fa.flash_attention_fwd(q, k, v, None, causal=causal,
                                               return_lse=True, plan=p))
            for p in fa.plans_at(d)})
    rows["flash_attention_bwd_dq"].update(
        plan=list(fa.bwd_plan_for(b, s, h, kv, d)),
        plans_ms={str(tuple(p)): graph_ms(
            lambda p=p: fa.flash_attention_bwd_dq(*bwd, causal=causal,
                                                  plan=p))
            for p in fa.bwd_plans_at(d)})
    return rows


def lm_train_gemm_rows(cfg, cgen, peak_flops, peak_bw) -> dict:
    """Each GEMM of the LM train step at M = batch x seq in fp32: the
    residual forward (the head reading the embedding transposed), dX and
    dW, each checked against its plain version (the head's dX and forward
    bitwise a row-major copy's) and timed (kernel, plain, torch.matmul by
    CUDA events; bound), summed per step by the step's launch counts (q /
    o and k / v share a shape and are measured once).  The bar is
    FP32_TOL for a contraction of up to 4096 terms and grows with the
    square root of a longer one (`gemm_tol`): the head's dX sums 151936
    products in one fp32 chain, and two summation orders of that many
    terms part by about 2.4e-7 sqrt(151936 / 4096) relative.  Each row
    also gives the kernel's and the plain version's distance from an fp64
    product, to show which order lies nearer.  Returns per kernel the
    sums and the fp32 max-abs error."""
    m = LM_TRAIN["batch"] * LM_TRAIN["seq"]
    dev = cgen.device
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")
    tot = {name: dict.fromkeys(keys, 0.0) | {"max_abs_err": 0.0}
           for name in ("gemm_fused_fwd_res", "gemm_bwd_dx", "gemm_bwd_dw")}
    measured = {}
    for g in lm_gemms(cfg):
        k, n, act, trans = g["k"], g["n"], g["act"], g["trans"]
        per_step = {"gemm_fused_fwd_res": 2 * g["per_dispatch"],
                    "gemm_bwd_dx": g["per_dispatch"],
                    "gemm_bwd_dw": g["per_dispatch"]}
        key = (k, n, act, g["shift"], trans)
        if key in measured:
            for name, row in measured[key].items():
                for kk in keys:
                    tot[name][kk] += per_step[name] * row[kk]
            continue
        measured[key] = {}
        x, w, _, shift = operands(m, k, n, torch.float32, cgen, trans)
        sh = shift if g["shift"] else None
        dy = torch.randn(m, n, generator=cgen, device=dev)
        plan = ops.default_tiles(m, k, n)
        dx_plan = ops.bwd_plan("dx", m, n, k)
        dw_plan = (ops.bwd_plan("dw", n, m, k) if trans
                   else ops.bwd_plan("dw", k, m, n))
        dx_args = dict(plan=dx_plan[0], splits=dx_plan[1])
        dw_args = dict(plan=dw_plan[0], splits=dw_plan[1])
        dw_ops = (dy, x) if trans else (x, dy)
        kernels = {
            "gemm_fused_fwd_res": (
                lambda: gemm.gemm_fused_fwd(x, w, None, sh, act=act,
                                            plan=plan, residuals=True),
                lambda: gemm.gemm_fused_res_plain(x, w, None, sh, act=act),
                lambda: torch.matmul(x, w),
                4.0 * (m * k + k * n + (2 + (act != "linear")) * m * n), k,
                lambda: epilogue(x.double() @ w.double(), None,
                                 None if sh is None else sh.double(), act)),
            "gemm_bwd_dx": (
                lambda: gemm.gemm_bwd_dx(dy, w, **dx_args),
                lambda: gemm.gemm_bwd_dx_plain(dy, w),
                lambda: torch.matmul(dy, w.t()),
                4.0 * (m * n + k * n + m * k), n,
                lambda: dy.double() @ w.double().t()),
            "gemm_bwd_dw": (
                lambda: gemm.gemm_bwd_dw(*dw_ops, **dw_args),
                lambda: gemm.gemm_bwd_dw_plain(*dw_ops),
                lambda: torch.matmul(dw_ops[0].t(), dw_ops[1]),
                4.0 * (m * k + m * n + k * n), m,
                lambda: dw_ops[0].double().t() @ dw_ops[1].double())}
        for name, (fn, plain, library, nbytes, kdim, exact) in \
                kernels.items():
            got, want = fn(), plain()
            got, want = (got[0], want[0]) if isinstance(got, tuple) else (
                got, want)
            err, tol = relmax(got, want), gemm_tol(kdim)
            check(bool(torch.isfinite(got).all()) and err <= tol,
                  f"{name} vs plain at the LM train GEMM {g['name']} "
                  f"{(m, k, n)}: {err:.3e} > {tol:.3e}")
            ref64 = exact()
            fp64 = {"kernel": relmax(got, ref64), "plain": relmax(want,
                                                                   ref64)}
            del ref64
            tot[name]["max_abs_err"] = max(tot[name]["max_abs_err"], float(
                (got - want).abs().max()))
            if trans and name != "gemm_bwd_dw":
                wr = w.contiguous()
                same = (gemm.gemm_bwd_dx(dy, wr, **dx_args)
                        if name == "gemm_bwd_dx" else gemm.gemm_fused_fwd(
                            x, wr, None, sh, act=act, plan=plan,
                            residuals=True)[0])
                check(torch.equal(got, same), f"the transposed head's "
                      f"{name} is not a row-major copy's bits")
                del wr, same
            del got, want
            row = {"relmax": err, "tol": tol, "relmax_fp64": fp64,
                   "ms": cuda_ms(fn, reps=3, repeats=3),
                   "plain_ms": cuda_ms(plain, reps=3, repeats=3),
                   "library_ms": cuda_ms(library, reps=3, repeats=3),
                   "ops_ms": 2.0 * m * k * n / peak_flops * 1e3,
                   "bytes_ms": nbytes / peak_bw * 1e3}
            row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
            emit("timing_lm_train_gemm", kernel=name, gemm=g["name"],
                 shape=[m, k, n], act=act, trans_w=trans,
                 plan=(list(plan) if name == "gemm_fused_fwd_res" else
                       dx_plan if name == "gemm_bwd_dx" else dw_plan),
                 per_step=per_step[name], **row,
                 bound_share=row["bound_ms"] / row["ms"])
            measured[key][name] = row
            for kk in keys:
                tot[name][kk] += per_step[name] * row[kk]
        del x, w, dy
    return tot


def gemm_tol(kdim: int) -> float:
    """The GEMM bar for a contraction of `kdim` terms (see
    `lm_train_gemm_rows`)."""
    return FP32_TOL * max(1.0, math.sqrt(kdim / 4096))


def train_step_timing(cfg, dev, run: dict, profiled=("cuda", "eager"),
                      batch=None) -> tuple[dict, dict]:
    """`make_train_step` (AdamW, remat, ce_chunk as train_loop) on `cuda`
    and `eager` at run's batch x seq from its seed (on `batch`, default
    train_loop's first): per engine the median host ms of a step
    (`host_ms`, 3 steps after a warm one), tokens/s and peak GB, and for
    the `profiled` engines one step's device time by kernel name
    (torch.profiler)."""
    seed, b, s = run["seed"], run["batch"], run["seq"]
    ocfg = opt.AdamWConfig(warmup_steps=1, decay_steps=run["steps"])
    if batch is None:
        batch = lm_train_batch(cfg, dev, 0, b, s, seed)
    steps, by_kernel = {}, {}
    for label in ("cuda", "eager"):
        params = lm_train_params(cfg, dev, seed)
        state = opt.adamw_init(flatten(params))
        step = make_train_step(make_engine(label, device=dev), cfg, ocfg,
                               ce_chunk=min(512, s))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = host_ms(lambda: step(params, state, batch), reps=3)
        steps[label] = {"ms": ms, "tokens_per_s": b * s / ms * 1e3,
                        "peak_gb": torch.cuda.max_memory_allocated(dev)
                        / 1e9}
        if label in profiled:
            by_kernel[label] = time_ssd.device_time_by_kernel(
                lambda: step(params, state, batch))
        del params, state, step
        torch.cuda.empty_cache()
    return steps, by_kernel


def timing_lm_train_phase(cfg, dev, cgen, peak_flops, peak_bw, smi,
                          launches: dict) -> dict:
    """Phase timing_lm_train (see the module docstring); `launches` are
    phase lm_train's counts over its LM_TRAIN["steps"] steps."""
    b, s = LM_TRAIN["batch"], LM_TRAIN["seq"]
    steps, by_kernel = train_step_timing(cfg, dev, LM_TRAIN, ("cuda",))
    device_ms = sum(r["ms"] for r in by_kernel["cuda"].values())
    emit("timing_lm_train_step", smi=smi, arch=LM_ARCH, batch=b, seq=s,
         steps=steps, device_ms=device_ms,
         device_busy_share=device_ms / steps["cuda"]["ms"],
         top_kernels=dict(list(by_kernel["cuda"].items())[:20]))
    rows = attn_train_rows((b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                            True), cgen, peak_flops, peak_bw)
    for name, row in rows.items():
        emit("timing_lm_train", kernel=name, smi=smi,
             launches_per_step=launches[name] // LM_TRAIN["steps"],
             shape=[b, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
             causal=True, **row)
    gemms = lm_train_gemm_rows(cfg, cgen, peak_flops, peak_bw)
    emit("timing_lm_train_gemm_total", smi=smi, m=b * s, per_step=gemms)
    return {"attn": rows, "gemm": gemms}


# ---------------------------------------------------------------- the SSM ---

def ssd_operands(b, s, h, p, g, n, dtype, gen, init=False):
    """SSD operands drawn on the card from the CUDA generator `gen`: x
    (b, s, h, p), dt = softplus(N(0,1) - 0.5), A = -exp(0.3 N(0,1)) per
    head, B and C (b, s, g, n), optionally an fp32 initial state."""
    dev = gen.device
    x = torch.randn(b, s, h, p, generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device=dev) - 0.5)
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))
    bm = torch.randn(b, s, g, n, generator=gen, device=dev).to(dtype)
    cm = torch.randn(b, s, g, n, generator=gen, device=dev).to(dtype)
    init = (torch.randn(b, h, p, n, generator=gen, device=dev) if init
            else None)
    return x, dt, a, bm, cm, init


def ssm_serve_requests(cfg) -> list:
    """Phase ssm_serve's requests, made anew from their seed."""
    return requests(cfg, SSM_SERVE["requests"], 10, SSM_SERVE["prompt"],
                    SSM_SERVE["new"])


def ssd_shape(cfg, b, s) -> tuple:
    """check_ssd's case tuple for `cfg`'s mixer at batch `b`, length `s`."""
    return (b, s, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups,
            cfg.ssm_state, cfg.ssm_chunk)


def ssm_serve_shapes(cfg) -> list:
    """The SSD shape of each ssm_serve request, in request order: the slot
    engine prefills all of a prompt but its last token at batch 1."""
    return [ssd_shape(cfg, 1, len(r.prompt) - 1)
            for r in ssm_serve_requests(cfg)]


def check_ssd_case(case, dtype, init, cgen) -> tuple[float, float, int]:
    """The SSD kernel against its plain version at one case (b, s, h, p,
    g, n, chunk), with or without an initial state: y and the final state
    within the bar of `dtype`, two runs bitwise equal, every plan
    (ssd.PLANS) bitwise the path plan's.  Returns (max-relative error,
    max-abs error, outputs compared bitwise)."""
    b, s, h, p, g, n, chunk = case
    x, dt, a, bm, cm, st = ssd_operands(b, s, h, p, g, n, dtype, cgen, init)
    got = ops.ssd(x, dt, a, bm, cm, chunk=chunk, init_state=st)
    again = ops.ssd(x, dt, a, bm, cm, chunk=chunk, init_state=st)
    want = ssd.ssd_scan_plain(x, dt, (dt * a).contiguous(), bm, cm,
                              chunk=chunk, init_state=st)
    torch.cuda.synchronize()
    where = f"{case} {dtype} init={init}"
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"non-finite SSD output at {where}")
    err = max(relmax(got[0], want[0]), relmax(got[1], want[1]))
    check(err <= (FP32_TOL if dtype == torch.float32 else BF16_TOL),
          f"SSD kernel vs plain {err:.3e} at {where}")
    check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
          f"two SSD runs differ at {where}")
    da = (dt * a).contiguous()
    bits = 0
    for plan in ssd.PLANS:
        other = ssd.ssd_scan(x, dt, da, bm, cm, chunk=chunk, init_state=st,
                             plan=plan)
        check(torch.equal(other[0], got[0]) and torch.equal(other[1], got[1]),
              f"SSD plan {plan} differs from the path plan's bits at "
              f"{where}")
        bits += 2
    mabs = max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))
    return err, mabs, bits


def check_ssd_phase(cfg, cgen) -> dict:
    """Phase check_ssd: the SSD kernel against its plain version over
    SSD_GRID, the ssm phase's prefill shape and every shape ssm_serve
    gives it, fp32 and bf16, with and without an initial state; y and the
    final state within the bars, two runs bitwise equal, every plan
    (ssd.PLANS) bitwise the path plan's.  Returns the worst fp32 max-abs
    error of y and the state at the prefill shape and over the serve
    shapes."""
    prefill = ssd_shape(cfg, *SSM_PREFILL)
    serve = sorted(set(ssm_serve_shapes(cfg)))
    rows, worst = [], {"fp32": 0.0, "bf16": 0.0}
    path_abs = {"prefill": 0.0, "serve": 0.0}
    bits = 0
    for case in [*SSD_GRID, prefill, *serve]:
        for dtype, kind in ((torch.float32, "fp32"), (torch.bfloat16,
                                                      "bf16")):
            for init in (False, True):
                err, mabs, n = check_ssd_case(case, dtype, init, cgen)
                bits += n
                worst[kind] = max(worst[kind], err)
                which = ("prefill" if case == prefill else
                         "serve" if case in serve else None)
                if which and kind == "fp32":
                    path_abs[which] = max(path_abs[which], mabs)
                rows.append({"case": list(case), "dtype": kind,
                             "init": init, "relmax": err,
                             "plan": list(ssd.plan_for(*case))})
    emit("check_ssd", cases=len(rows), relmax=worst,
         plans=[list(p) for p in ssd.PLANS], plan_outputs_bitwise=bits,
         prefill_shape=list(prefill), serve_shapes=[list(c) for c in serve],
         max_abs_err=path_abs, rows=rows)
    return path_abs


def ssm_params(cfg, dev):
    """Full-width random parameters from a seed, with every head's dt bias,
    A and D moved off the init's constants (so the heads decay at
    different rates and the D skip is tested)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    params = tfm.init_params(cfg, generator=gen, device=dev)
    with torch.no_grad():
        for lp in params["layers"]:
            for name, scale in (("dt_bias", 0.5), ("A_log", 0.3),
                                ("D", 0.5)):
                t = lp["mixer"][name]
                t.add_(torch.randn(t.shape, generator=gen, device=dev)
                       * scale)
    return params


def ssm_phase(cfg, params, dev) -> float:
    """Phase ssm: cuda vs eager prefill and 16 decode steps at full width.
    Returns the largest max-abs logit difference of the two."""
    cuda, eager = make_engine("cuda"), make_engine("eager", device=dev)
    b, s = SSM_PREFILL
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
    out, launches = {}, {}
    with torch.inference_mode():
        for label, engine in (("cuda", cuda), ("eager", eager)):
            reset_all_launches()
            out[label] = make_prefill_step(engine, cfg)(
                params, {"tokens": tokens})
            torch.cuda.synchronize()
            launches[label] = {**all_launches(), "dispatch": {
                f"{k[0]}.{k[1]}": v
                for k, v in backends.dispatch_counts().items()}}
        (lc, cc), (le, ce) = out["cuda"], out["eager"]
        logit_err = relmax(lc[..., :cfg.vocab_size], le[..., :cfg.vocab_size])
        cache_err = {name: max(relmax(cc[0][name][i], t[i])
                               for i in range(cfg.n_layers))
                     for name, t in ce[0].items()}
        v = cfg.vocab_size
        abs_err = float((lc[..., :v] - le[..., :v]).abs().max())
        decode_err, agree = [], 0
        tok = le[:, -1].argmax(-1, keepdim=True)
        for step in range(SSM_DECODE_STEPS):
            lc, cc = make_decode_step(cuda, cfg)(params, cc, tok, s + step)
            le, ce = make_decode_step(eager, cfg)(params, ce, tok, s + step)
            decode_err.append(relmax(lc[..., :v], le[..., :v]))
            abs_err = max(abs_err, float((lc[..., :v] - le[..., :v]).abs()
                                         .max()))
            nxt = le[:, -1].argmax(-1, keepdim=True)
            agree += int(torch.equal(lc[:, -1].argmax(-1, keepdim=True), nxt))
            tok = nxt
        state_err = relmax(cc[0]["ssm"], ce[0]["ssm"])
    torch.cuda.synchronize()
    emit("ssm", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         heads=cfg.ssm_nheads, head_dim=cfg.ssm_headdim,
         state=cfg.ssm_state, chunk=cfg.ssm_chunk, batch=b, prompt=s,
         logits_relmax=logit_err, cache_relmax=cache_err,
         decode_steps=SSM_DECODE_STEPS, decode_relmax=decode_err,
         state_relmax_after_decode=state_err, greedy_agree=agree,
         logits_max_abs_err=abs_err, launches=launches)
    check(bool(torch.isfinite(out["cuda"][0][..., :cfg.vocab_size]).all()),
          "non-finite prefill logits")
    check(logit_err <= LOGIT_TOL, f"prefill logits cuda vs eager "
          f"{logit_err:.3e}")
    check(max(cache_err.values()) <= LOGIT_TOL,
          f"prefill caches cuda vs eager {cache_err}")
    check(max(decode_err) <= LOGIT_TOL,
          f"decode logits cuda vs eager {decode_err}")
    check(launches["cuda"]["ssd_scan"] == cfg.n_layers
          and launches["cuda"]["dispatch"].get("cuda.ssd") == cfg.n_layers,
          f"the cuda prefill did not run the SSD kernel once per layer: "
          f"{launches['cuda']}")
    check(sum(v for k, v in launches["eager"].items() if k != "dispatch")
          == 0, "the eager engine launched a kernel of the port")
    return abs_err


def ssm_serve_phase(cfg, params, dev, abs_err) -> dict:
    """Phase ssm_serve: the slot engine on cuda; reused slots vs alone, and
    every stream vs the slot engine on eager on the card, where a token may
    differ only at a near tie (eager top-2 margin below MARGIN_FACTOR times
    the ssm phase's max-abs logit difference, `abs_err`)."""
    cuda, eager = make_engine("cuda"), make_engine("eager", device=dev)
    n = SSM_SERVE["requests"]
    kw = dict(engine=cuda, slots=SSM_SERVE["slots"],
              max_len=SSM_SERVE["max_len"])
    server = ServingEngine(cfg, params, **kw)
    reqs = ssm_serve_requests(cfg)
    reset_all_launches()
    t0 = time.perf_counter()
    server.run(reqs)  # ---- the main path, driven once
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    dispatch = backends.dispatch_counts()
    st = server.stats()
    # the first `slots` requests took fresh slots, the rest reused ones:
    # each of those alone on a fresh engine must give the same stream
    reused = reqs[SSM_SERVE["slots"]:]
    alone = ssm_serve_requests(cfg)[SSM_SERVE["slots"]:]
    for r in alone:
        ServingEngine(cfg, params, **kw).run([r])
    same = [a.out == r.out for a, r in zip(alone, reused)]
    plain = ssm_serve_requests(cfg)
    ServingEngine(cfg, params, **{**kw, "engine": eager}).run(plain)
    head = tfm.head_weight(params, cfg)
    mismatches = []
    for a, r in zip(plain, reqs):
        check(a.done and len(a.out) == len(r.out),
              f"eager request {a.rid} did not complete as cuda's did")
        if a.out == r.out:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a.out, r.out)) if x != y)
        with torch.inference_mode():
            h, _ = tfm.forward_hidden(eager, cfg, params, tokens=torch.tensor(
                [a.prompt + a.out[:j]], device=dev))
            top2 = torch.topk(h[0, -1] @ head, 2).values
        mismatches.append({"rid": a.rid, "token": j,
                           "eager_margin": float(top2[0] - top2[1]),
                           "allowed_below": MARGIN_FACTOR * abs_err})
    emit("ssm_serve", arch=cfg.name, slots=SSM_SERVE["slots"], requests=n,
         completed=st["requests"]["completed"], tokens=st["tokens"],
         prompt_tokens=sum(len(r.prompt) for r in reqs), steps=st["steps"],
         wall_s=wall, tokens_per_s=st["throughput"],
         p50_ms=st["latency_s"]["p50"] * 1e3,
         p99_ms=st["latency_s"]["p99"] * 1e3, launches=launches,
         engine_dispatch={f"{b}.{o}": c for (b, o), c in dispatch.items()},
         reused_slot_requests=len(reused), equal_to_alone=same,
         eager_tokens=sum(len(a.out) for a in plain),
         eager_mismatches=mismatches)
    check(st["requests"]["completed"] == n
          and all(r.done and len(r.out) == r.max_new for r in reqs),
          f"{st['requests']['completed']} of {n} completed")
    check(launches["ssd_scan"] == n * cfg.n_layers
          and launches["gemm_fused_fwd"] > 0,
          f"the main path skipped a kernel: {launches}")
    # prompts of at most 48 tokens, decode batches of at most 4 rows
    check(launches["gemm_fwd_regime_a"] == launches["gemm_fused_fwd"]
          and launches["gemm_fwd_regime_b"] == 0,
          f"SSM serving GEMMs outside regime A: {launches}")
    check(all(b == "cuda" for b, _ in dispatch),
          f"an engine op left the cuda backend: {dispatch}")
    check(all(same), f"a reused slot's stream differs from the request "
          f"alone: {same}")
    check(all(m["eager_margin"] < m["allowed_below"] for m in mismatches),
          f"cuda vs eager slot-engine token mismatch at a clear margin: "
          f"{mismatches}")
    return {"launches": launches, "stats": st, "wall_s": wall}


def timing_ssm_phase(cfg, params, dev, cgen, peak_flops, peak_bw,
                     smi) -> dict:
    """Phase timing_ssm: prefill and decode ms at batch 1 and 4, the SSD
    kernel (kernel, plain, bound) at the prefill shape and at 4 x 2048 and
    at each shape ssm_serve gives it (device time from a CUDA graph; the
    `serve` row is the mean over ssm_serve's requests), and the device
    time by kernel name of one prefill and of one decode step at batch
    4."""
    cuda, eager = make_engine("cuda"), make_engine("eager", device=dev)
    s = SSM_PREFILL[1]
    rng = np.random.default_rng(11)
    steps = {}
    with torch.inference_mode():
        for b in (1, SSM_PREFILL[0]):
            tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                   (b, s))).to(dev)
            for label, engine in (("cuda", cuda), ("eager", eager)):
                prefill = make_prefill_step(engine, cfg)
                decode = make_decode_step(engine, cfg)
                _, caches = prefill(params, {"tokens": tokens})
                tok = tokens[:, -1:]
                pre = host_ms(lambda: prefill(params, {"tokens": tokens}),
                              reps=3)
                dec = host_ms(lambda: decode(params, caches, tok, s))
                steps[f"{label}_b{b}"] = {
                    "prefill_ms": pre, "prefill_tokens_per_s": b * s / pre
                    * 1e3, "decode_step_ms": dec,
                    "decode_ms_per_token": dec / b}
                if label == "cuda" and b == SSM_PREFILL[0]:
                    decode_kernels = time_ssd.device_time_by_kernel(
                        lambda: decode(params, caches, tok, s))
                    regimes = {
                        "prefill": regime_counts(lambda: prefill(
                            params, {"tokens": tokens})),
                        "decode": regime_counts(lambda: decode(
                            params, caches, tok, s))}
                del caches
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, SSM_PREFILL)).to(dev)
        prefill = make_prefill_step(cuda, cfg)
        by_kernel = time_ssd.device_time_by_kernel(
            lambda: prefill(params, {"tokens": tokens}))
    device_ms = sum(r["ms"] for r in by_kernel.values())
    decode_ms = sum(r["ms"] for r in decode_kernels.values())
    cuda_b = steps[f"cuda_b{SSM_PREFILL[0]}"]
    # a prefill's projections take regime B, its last-position head and
    # every decode GEMM regime A
    per_layer = 6 * cfg.n_layers
    check(regimes == {"prefill": {"A": 1, "B": per_layer},
                      "decode": {"A": per_layer + 1, "B": 0}},
          f"SSM GEMM launches by regime {regimes}")
    plans = {f"{g['name']}@{m}": list(ops.default_tiles(m, g["k"], g["n"]))
             for m in (SSM_PREFILL[0] * s, SSM_PREFILL[0])
             for g in ssm_gemms(cfg)}
    emit("timing_ssm_step", smi=smi, arch=cfg.name, prompt=s, steps=steps,
         regime_launches=regimes, gemm_plans=plans,
         prefill_device_ms=device_ms,
         prefill_busy_share=device_ms / cuda_b["prefill_ms"],
         top_kernels=dict(list(by_kernel.items())[:20]),
         decode_device_ms=decode_ms,
         decode_busy_share=decode_ms / cuda_b["decode_step_ms"],
         decode_top_kernels=dict(list(decode_kernels.items())[:12]))
    rows = {}
    serve = ssm_serve_shapes(cfg)
    for case in [ssd_shape(cfg, *SSM_PREFILL), ssd_shape(cfg, 4, 2048),
                 *sorted(set(serve))]:
        b, seq, chunk = case[0], case[1], case[6]
        x, dt, a, bm, cm, _ = ssd_operands(*case[:6], torch.float32, cgen)
        da = (dt * a).contiguous()

        def kernel():
            return ops.ssd(x, dt, a, bm, cm, chunk=chunk)

        def plain():
            return ssd.ssd_scan_plain(x, dt, da, bm, cm, chunk=chunk)

        if case in serve:  # small: enqueueing would outlast the kernel
            ms, plain_ms = graph_ms(kernel), graph_ms(plain)
        else:
            ms = cuda_ms(kernel, reps=5)
            plain_ms = cuda_ms(plain, reps=2, repeats=3)
        flops, nbytes = time_ssd.ssd_work(x, bm, chunk)
        bound_ms, bound_by = bound(flops, nbytes, peak_flops, peak_bw)
        rows[f"{b}x{seq}"] = row = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "ops_ms": flops / peak_flops * 1e3,
            "bytes_ms": nbytes / peak_bw * 1e3, "library_ms": None,
            "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms}
        emit("timing_ssm", kernel="ssd_scan", smi=smi, shape=list(case),
             **row)
        del x, dt, a, bm, cm, da
    per_request = [rows[f"1x{c[1]}"] for c in serve]
    mean = {k: statistics.mean(r[k] for r in per_request)
            for k in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms")}
    rows["serve"] = row = {
        **mean, "library_ms": None,
        "bound_by": ("operations" if mean["ops_ms"] >= mean["bytes_ms"]
                     else "bytes"),
        "bound_share": mean["bound_ms"] / mean["ms"],
        "lengths": [c[1] for c in serve]}
    emit("timing_ssm", kernel="ssd_scan", smi=smi, shape="ssm_serve mean",
         **row)
    return {"steps": steps, "ssd": rows}


# ------------------------------------------------- the bmm op, direct conv ---

def bmm_plans(b, m, k, n) -> tuple:
    """The plans `ops.bmm` gives (B, M, K, N): the forward's plan, and the
    (plan, splits) of dX and of dW (the backward plans count the batch)."""
    return (ops.bmm_plan_for(m, k, n), ops.bwd_plan("dx", m, n, k, b),
            ops.bwd_plan("dw", k, m, n, b))


def check_bmm_case(b, m, k, n, plans, gen) -> dict:
    """The three bmm kernels against their plain versions at (B, M, K, N),
    fp32 and bf16, for each (forward plan, backward plan, splits) in
    `plans`: fp32 within gemm_tol of each kernel's contraction (K, N, M),
    bf16 within BF16_TOL; every batch slice bitwise the 2-D kernel's
    (`gemm_fused_fwd` linear without scale or shift, `gemm_bwd_dx`,
    `gemm_bwd_dw`) at the same plan; a rerun bitwise; every backward plan
    bitwise the given one at the same split."""
    dev = gen.device
    worst = {name: {"fp32": 0.0, "bf16": 0.0} for name in BMM_KERNELS}
    max_abs = dict.fromkeys(BMM_KERNELS, 0.0)
    for dt in (torch.float32, torch.bfloat16):
        kind = "fp32" if dt == torch.float32 else "bf16"
        x = torch.randn(b, m, k, generator=gen, device=dev).to(dt)
        w = (torch.randn(b, k, n, generator=gen, device=dev)
             / math.sqrt(k)).to(dt)
        dy = torch.randn(b, m, n, generator=gen, device=dev).to(dt)
        cases = {
            "bmm_fwd": (k, gemm.bmm_fwd_plain(x, w),
                        lambda p, t, s: gemm.bmm_fwd(x, w, plan=p),
                        lambda i, p, t, s: gemm.gemm_fused_fwd(x[i], w[i],
                                                               plan=p)),
            "bmm_bwd_dx": (n, gemm.bmm_bwd_dx_plain(dy, w),
                           lambda p, t, s: gemm.bmm_bwd_dx(dy, w, plan=t,
                                                           splits=s),
                           lambda i, p, t, s: gemm.gemm_bwd_dx(
                               dy[i], w[i], plan=t, splits=s)),
            "bmm_bwd_dw": (m, gemm.bmm_bwd_dw_plain(x, dy),
                           lambda p, t, s: gemm.bmm_bwd_dw(x, dy, plan=t,
                                                           splits=s),
                           lambda i, p, t, s: gemm.gemm_bwd_dw(
                               x[i], dy[i], plan=t, splits=s))}
        for name, (kdim, want, fn, slice2d) in cases.items():
            tol = gemm_tol(kdim) if kind == "fp32" else BF16_TOL
            for plan in plans:
                where = (f"{name} at {(b, m, k, n)} {dt} plan={plan}")
                got = fn(*plan)
                check(bool(torch.isfinite(got).all()), f"non-finite {where}")
                err = relmax(got, want)
                check(err <= tol, f"{where}: {err:.3e} > {tol:g}")
                check(torch.equal(got, fn(*plan)),
                      f"two runs of {where} differ")
                for i in range(b):
                    check(torch.equal(got[i], slice2d(i, *plan)),
                          f"{where}: batch slice {i} differs from the 2-D "
                          f"kernel")
                if name != "bmm_fwd":
                    for other in gemm.BWD_PLANS:
                        check(torch.equal(got, fn(plan[0], other, plan[2])),
                              f"{where}: backward plan {tuple(other)} "
                              f"differs")
                worst[name][kind] = max(worst[name][kind], err)
                if kind == "fp32":
                    max_abs[name] = max(max_abs[name], float(
                        (got - want).abs().max()))
                del got
        del x, w, dy, cases
    return {"shape": [b, m, k, n],
            "plans": [[list(p), list(t), s] for p, t, s in plans],
            "relmax": worst, "max_abs_err_fp32": max_abs}


def check_bmm_phase(cgen) -> dict:
    """Phase check_bmm: BMM_CASES under every forward plan, backward plan
    and split count 1 and 3, then the llama4-scout expert shapes at the
    path's plans.  Returns the fp32 max-abs error of each kernel at the
    expert shapes."""
    forced = [(p, t, s) for p, t in zip(gemm.PLANS, gemm.BWD_PLANS * 2)
              for s in (1, 3)]
    for case in BMM_CASES:
        emit("check_bmm", **check_bmm_case(*case, forced, cgen))
    path_abs = dict.fromkeys(BMM_KERNELS, 0.0)
    for case in EXPERT_BMM:
        plan, dx_plan, dw_plan = bmm_plans(*case)
        plans = [(plan, *dx_plan)] + ([] if dx_plan == dw_plan
                                      else [(plan, *dw_plan)])
        res = check_bmm_case(*case, plans, cgen)
        emit("check_bmm", arch="llama4-scout-17b-a16e", **res)
        for name in path_abs:
            path_abs[name] = max(path_abs[name],
                                 res["max_abs_err_fp32"][name])
        torch.cuda.empty_cache()
    return path_abs


def engine_bmm_phase(dev) -> dict:
    """Phase engine_bmm: `make_engine("cuda").bmm` and the gradient of
    sum(y**2) by autograd at the expert shape, the launch counts set to 0
    just before and read just after, against `eager` on the card."""
    b, m, k, n = EXPERT_BMM[0]
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(b, m, k, generator=gen, device=dev)
    w = torch.randn(b, k, n, generator=gen, device=dev) / math.sqrt(k)
    runs = {}
    for label in ("cuda", "eager"):
        engine = make_engine(label, device=dev)
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        y = engine.bmm(xr, wr)  # ---- for "cuda": this slice's path
        dx, dw = torch.autograd.grad((y ** 2).sum(), (xr, wr))
        torch.cuda.synchronize()
        runs[label] = {"y": y.detach(), "dx": dx, "dw": dw,
                       "wall_s": time.perf_counter() - t0,
                       "launches": all_launches(),
                       "dispatch": backends.dispatch_counts()}
        del xr, wr, y
    cu, ea = runs["cuda"], runs["eager"]
    _, (_, dx_splits), (_, dw_splits) = bmm_plans(b, m, k, n)
    regime = f"gemm_fwd_regime_{ops.bmm_plan_for(m, k, n).regime.lower()}"
    want = {**dict.fromkeys(cu["launches"], 0), "bmm_fwd": 1, regime: 1,
            "bmm_bwd_dx": 1, "bmm_bwd_dw": 1,
            "gemm_bwd_reduce": (dx_splits > 1) + (dw_splits > 1)}
    err = {key: relmax(cu[key], ea[key]) for key in ("y", "dx", "dw")}
    bars = {"y": gemm_tol(k), "dx": TRAIN_TOL, "dw": TRAIN_TOL}
    max_abs = {key: float((cu[key] - ea[key]).abs().max())
               for key in ("y", "dx", "dw")}
    emit("engine_bmm", shape=[b, m, k, n], arch="llama4-scout-17b-a16e",
         relmax=err, bars=bars, max_abs_err=max_abs,
         launches=cu["launches"], want_launches=want,
         dispatch={f"{bk}.{o}": c for (bk, o), c in cu["dispatch"].items()},
         eager_launches=sum(ea["launches"].values()),
         wall_s={key: r["wall_s"] for key, r in runs.items()})
    check(tuple(cu["y"].shape) == (b, m, n) and tuple(cu["dx"].shape)
          == (b, m, k) and tuple(cu["dw"].shape) == (b, k, n),
          "engine bmm shapes")
    check(all(bool(torch.isfinite(cu[key]).all())
              for key in ("y", "dx", "dw")), "non-finite engine bmm")
    for key, bar in bars.items():
        check(err[key] <= bar, f"engine bmm {key} cuda vs eager "
              f"{err[key]:.3e} > {bar:g}")
    check(cu["launches"] == want,
          f"engine bmm launches {cu['launches']}, want {want}")
    check(cu["dispatch"] == {("cuda", "bmm"): 1},
          f"engine bmm dispatches {cu['dispatch']}")
    check(sum(ea["launches"].values()) == 0
          and ea["dispatch"] == {("eager", "bmm"): 1},
          "the eager engine launched a kernel of the port")
    return {"launches": cu["launches"], "max_abs_err": max_abs}


def timing_bmm_phase(gen, peak_flops, peak_bw, smi) -> dict:
    """Phase timing_bmm: each bmm kernel at the engine_bmm shape with the
    path's plan (`bmm_rows`)."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off")
    rows = bmm_rows(EXPERT_BMM[0], gen, peak_flops, peak_bw)
    for name, row in rows.items():
        emit("timing_bmm", kernel=name, smi=smi, **row)
    return rows


def bmm_rows(shape, gen, peak_flops, peak_bw, kernels=BMM_KERNELS) -> dict:
    """Each bmm kernel of `kernels` at (B, M, K, N) with the path's plan
    and split (`bmm_plans`), operands drawn from `gen`: kernel, plain,
    torch.bmm (TF32 off, a baseline only) and bound ms (2 B M K N
    FFMA-rate operations; each operand read once, the output written
    once), by CUDA events."""
    b, m, k, n = shape
    dev = gen.device
    x = torch.randn(b, m, k, generator=gen, device=dev)
    w = torch.randn(b, k, n, generator=gen, device=dev) / math.sqrt(k)
    dy = torch.randn(b, m, n, generator=gen, device=dev)
    plan, (dxt, dxs), (dwt, dws) = bmm_plans(b, m, k, n)
    nbytes = 4.0 * (b * m * k + b * k * n + b * m * n)
    flops = 2.0 * b * m * k * n
    calls = {
        "bmm_fwd": (lambda: gemm.bmm_fwd(x, w, plan=plan),
                    lambda: gemm.bmm_fwd_plain(x, w), lambda: torch.bmm(x, w)),
        "bmm_bwd_dx": (lambda: gemm.bmm_bwd_dx(dy, w, plan=dxt, splits=dxs),
                       lambda: gemm.bmm_bwd_dx_plain(dy, w),
                       lambda: torch.bmm(dy, w.transpose(1, 2))),
        "bmm_bwd_dw": (lambda: gemm.bmm_bwd_dw(x, dy, plan=dwt, splits=dws),
                       lambda: gemm.bmm_bwd_dw_plain(x, dy),
                       lambda: torch.bmm(x.transpose(1, 2), dy))}
    rows = {}
    for name in kernels:
        fn, plain, library = calls[name]
        ms = cuda_ms(fn, reps=5, repeats=3)
        plain_ms = cuda_ms(plain, reps=5, repeats=3)
        library_ms = cuda_ms(library, reps=5, repeats=3)
        bound_ms, bound_by = bound(flops, nbytes, peak_flops, peak_bw)
        rows[name] = {
            "shape": [b, m, k, n],
            "plans": {"forward": list(plan), "dx": [dxt, dxs],
                      "dw": [dwt, dws]},
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ops_ms": flops / peak_flops * 1e3,
            "bytes_ms": nbytes / peak_bw * 1e3,
            "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms}
    del x, w, dy
    return rows


def train_bmm_rows(phase, cfg, run: dict, gen, peak_flops, peak_bw, smi,
                   launches: dict) -> dict:
    """Phase timing_<phase>'s expert rows: `bmm_bwd_dx` and `bmm_bwd_dw`
    at each distinct expert shape of the config's train step
    (`train_bmms`, `bmm_rows`), each emitted with its launches a step from
    `launches` (a step's counts); returns per kernel the ms, plain,
    library, bound, ops and bytes ms summed over one MoE layer's three
    expert GEMMs."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")
    tot = {name: dict.fromkeys(keys, 0.0) for name in BMM_KERNELS[1:]}
    shapes = train_bmms(cfg, run["batch"], run["seq"])
    for shape in dict.fromkeys(shapes):
        rows = bmm_rows(shape, gen, peak_flops, peak_bw, BMM_KERNELS[1:])
        for name, row in rows.items():
            emit(f"timing_{phase}", kernel=name, smi=smi,
                 per_layer=shapes.count(shape),
                 launches_per_step=launches[name], **row)
            for key in keys:
                tot[name][key] += shapes.count(shape) * row[key]
        torch.cuda.empty_cache()
    for name, row in tot.items():
        emit(f"timing_{phase}_expert_layer", kernel=name, smi=smi, **row)
    return tot


def path_convs(net: Network, batch: int) -> list[dict]:
    """The convolutions one forward of `net` runs at `batch`, in layer
    order: input (H, W, Cin), Cout, kernel size, stride and padding."""
    out, hwc = [], net.in_shape
    for p in net.plans:
        o = p.options
        if p.type == "convolutional":
            size = o.get("size", 3)
            out.append({"layer": p.index, "b": batch, "h": hwc[0],
                        "w": hwc[1], "cin": hwc[2], "cout": p.out_shape[2],
                        "size": size, "stride": o.get("stride", 1),
                        "pad": darknet_cfg.conv_pad(o, size)})
        hwc = p.out_shape
    return out


def conv_operands(c, dtype, gen):
    """(x, x padded outside, w (KH, KW, Cin, Cout)) of one layer `c`."""
    dev, p, size = gen.device, c["pad"], c["size"]
    x = torch.randn(c["b"], c["h"], c["w"], c["cin"], generator=gen,
                    device=dev).to(dtype)
    w = (torch.randn(size, size, c["cin"], c["cout"], generator=gen,
                     device=dev) / math.sqrt(size * size * c["cin"])
         ).to(dtype)
    return x, torch.nn.functional.pad(x, (0, 0, p, p, p, p)), w


def conv_plans_bits(xp, w, where) -> int:
    """Every conv plan against the path plan's output at one case, bit for
    bit, and a rerun of each; returns the outputs compared."""
    want = conv_direct.conv2d_direct(xp, w)
    for plan in conv_direct.PLANS:
        got = conv_direct.conv2d_direct(xp, w, plan=plan)
        check(torch.equal(got, want), f"{where}: plan {plan} differs from "
              f"the path plan's bits")
        check(torch.equal(got, conv_direct.conv2d_direct(xp, w, plan=plan)),
              f"{where}: two runs of plan {plan} differ")
    return len(conv_direct.PLANS)


def conv_direct_phase(net, gen, peak_flops, peak_bw, smi) -> dict:
    """Phase conv_direct: the 11 DARKNET19_CFG convolutions at batch
    CONV_BATCH through `conv2d_direct` on inputs padded outside, the
    launch counts set to 0 just before and read just after; then, fp32
    and bf16, each against its plain version and against the `cuda`
    engine's im2col conv2d (linear, no scale or shift), reruns bitwise,
    every plan bitwise the path plan's (also at CONV_RAGGED); then per
    layer (fp32) the kernel under `plan_for`'s plan, plain, im2col and
    cuDNN F.conv2d device ms (TF32 off; CUDA-graph replays, and the
    kernel's time with its enqueue) and the bound."""
    torch.backends.cudnn.allow_tf32 = False
    layers = path_convs(net, CONV_BATCH)
    check(len(layers) == 11 and all(c["stride"] == 1 for c in layers),
          f"DARKNET19 convolutions {layers}")
    data = [conv_operands(c, torch.float32, gen) for c in layers]
    torch.cuda.synchronize()
    reset_all_launches()
    outs = [conv_direct.conv2d_direct(xp, w)  # ---- this slice's path
            for _, xp, w in data]
    torch.cuda.synchronize()
    launches = all_launches()
    want = {**dict.fromkeys(launches, 0), "conv2d_direct": len(layers)}
    check(launches == want, f"conv_direct launches {launches}, want {want}")
    engines = {torch.float32: make_engine("cuda"),
               torch.bfloat16: make_engine("cuda", "mixed")}
    worst = {"plain": {"fp32": 0.0, "bf16": 0.0},
             "im2col": {"fp32": 0.0, "bf16": 0.0}}
    max_abs = 0.0
    plan_bits = 0
    for dt, engine in engines.items():
        kind = "fp32" if dt == torch.float32 else "bf16"
        for i, c in enumerate(layers):
            x, xp, w = (data[i] if kind == "fp32"
                        else conv_operands(c, dt, gen))
            got = outs[i] if kind == "fp32" else conv_direct.conv2d_direct(
                xp, w)
            size, cout = c["size"], c["cout"]
            tol = (gemm_tol(size * size * c["cin"]) if kind == "fp32"
                   else BF16_TOL)
            where = f"conv2d_direct layer {c['layer']} {dt}"
            check(tuple(got.shape) == (c["b"], c["h"], c["w"], cout),
                  f"{where}: shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"non-finite {where}")
            want_plain = conv_direct.conv2d_direct_plain(xp, w)
            want_im2col = engine.conv2d(x, w.reshape(-1, cout), size=size,
                                        pad=c["pad"], out_dtype=dt)
            for ref, key in ((want_plain, "plain"), (want_im2col, "im2col")):
                err = relmax(got, ref)
                check(err <= tol, f"{where} vs {key}: {err:.3e} > {tol:g}")
                worst[key][kind] = max(worst[key][kind], err)
            check(torch.equal(got, conv_direct.conv2d_direct(xp, w)),
                  f"two runs of {where} differ")
            plan_bits += conv_plans_bits(xp, w, where)
            if kind == "fp32":
                max_abs = max(max_abs, float((got - want_plain).abs().max()))
        for b, h, cin, cout, size in CONV_RAGGED:
            c = {"b": b, "h": h, "w": h + 3 * (h % 2), "cin": cin,
                 "cout": cout, "size": size, "pad": size // 2}
            _, xp, w = conv_operands(c, dt, gen)
            got = conv_direct.conv2d_direct(xp, w)
            where = f"conv2d_direct ragged {b, h, cin, cout, size} {dt}"
            err = relmax(got, conv_direct.conv2d_direct_plain(xp, w))
            check(err <= (FP32_TOL if kind == "fp32" else BF16_TOL),
                  f"{where} vs plain: {err:.3e}")
            plan_bits += conv_plans_bits(xp, w, where)
    torch.cuda.synchronize()
    emit("conv_direct", cfg="DARKNET19_CFG", batch=CONV_BATCH,
         layers=[[c["layer"], c["h"], c["w"], c["cin"], c["cout"],
                  c["size"]] for c in layers], launches=launches,
         relmax=worst, max_abs_err_fp32=max_abs,
         plans=[list(p) for p in conv_direct.PLANS],
         plan_outputs_bitwise=plan_bits, ragged=CONV_RAGGED)
    keys = ("ms", "enqueued_ms", "plain_ms", "im2col_ms", "library_ms",
            "bound_ms", "ops_ms", "bytes_ms")
    total = dict.fromkeys(keys, 0.0)
    for c, (x, xp, w) in zip(layers, data):
        size, cout = c["size"], c["cout"]
        w2 = w.reshape(-1, cout)
        xn = xp.permute(0, 3, 1, 2)  # NCHW view of the NHWC storage
        wn = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        plan = conv_direct.plan_for(*xp.shape, size, size, cout)
        ms = graph_ms(lambda: conv_direct.conv2d_direct(xp, w))
        enqueued_ms = cuda_ms(lambda: conv_direct.conv2d_direct(xp, w))
        plain_ms = graph_ms(lambda: conv_direct.conv2d_direct_plain(xp, w))
        im2col_ms = graph_ms(lambda: engines[torch.float32].conv2d(
            x, w2, size=size, pad=c["pad"]))
        library_ms = graph_ms(lambda: torch.nn.functional.conv2d(xn, wn))
        lib_err = relmax(torch.nn.functional.conv2d(xn, wn).permute(
            0, 2, 3, 1), conv_direct.conv2d_direct_plain(xp, w))
        flops = 2.0 * c["b"] * c["h"] * c["w"] * size * size * c["cin"] * cout
        nbytes = 4.0 * (xp.numel() + w.numel() + c["b"] * c["h"] * c["w"]
                        * cout)
        bound_ms, bound_by = bound(flops, nbytes, peak_flops, peak_bw)
        row = {"ms": ms, "enqueued_ms": enqueued_ms, "plain_ms": plain_ms,
               "im2col_ms": im2col_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "ops_ms": flops / peak_flops * 1e3,
               "bytes_ms": nbytes / peak_bw * 1e3}
        for key in keys:
            total[key] += row[key]
        emit("timing_conv_direct", layer=c["layer"], batch=CONV_BATCH,
             shape=[c["h"], c["w"], c["cin"], cout, size], plan=list(plan),
             **row, bound_by=bound_by, tflops=flops / ms / 1e9,
             bound_share=bound_ms / ms, library_relmax=lib_err)
    emit("timing_conv_direct_total", smi=smi, batch=CONV_BATCH,
         layers=len(layers), **total, bound_share=total["bound_ms"]
         / total["ms"])
    return {"launches": launches["conv2d_direct"], "max_abs_err": max_abs,
            "total": total}


def lm_mixed_phase(cfg, params, dev) -> dict:
    """Phase lm_mixed: the full-width prefill of MIXED_PROMPT tokens under
    the `mixed` policy (bf16 operands and activations, fp32 accumulation
    and parameters) on `cuda`, `eager` and `ref`, and on `eager` under
    `fp32_strict`, all on the card.  Over a deep stack two correct mixed
    programs drift apart by more than bf16 rounding (48 mamba2 layers at
    2 x 256 tokens on an H100: `ref` and `eager`, no kernel between them,
    7.9e-2 apart).  So `cuda` vs `eager` is held to MIXED_TOL or
    MIXED_FLOOR_FACTOR times the `ref` vs `eager` drift, whichever is
    larger, and `cuda`'s distance from the fp32 logits to MIXED_TOL or
    MIXED_FLOOR_FACTOR times `eager`'s (the kernels lose no accuracy that
    eager keeps).  Returns the errors."""
    b, s = MIXED_PROMPT
    tokens = torch.from_numpy(np.random.default_rng(17).integers(
        0, cfg.vocab_size, (b, s))).to(dev)
    logits = {}
    with torch.inference_mode():
        for label, backend, policy in (("cuda", "cuda", "mixed"),
                                       ("eager", "eager", "mixed"),
                                       ("ref", "ref", "mixed"),
                                       ("fp32", "eager", "fp32_strict")):
            engine = make_engine(backend, policy, device=dev)
            out, _ = make_prefill_step(engine, cfg)(params,
                                                    {"tokens": tokens})
            logits[label] = out[..., :cfg.vocab_size].float()
    torch.cuda.synchronize()
    err = {"cuda_eager": relmax(logits["cuda"], logits["eager"]),
           "ref_eager": relmax(logits["ref"], logits["eager"]),
           "cuda_fp32": relmax(logits["cuda"], logits["fp32"]),
           "eager_fp32": relmax(logits["eager"], logits["fp32"])}
    bars = {"cuda_eager": max(MIXED_TOL,
                              MIXED_FLOOR_FACTOR * err["ref_eager"]),
            "cuda_fp32": max(MIXED_TOL,
                             MIXED_FLOOR_FACTOR * err["eager_fp32"])}
    emit("lm_mixed", arch=cfg.name, batch=b, prompt=s, policy="mixed",
         relmax=err, bars=bars, floor_factor=MIXED_FLOOR_FACTOR,
         logits_max_abs=float(logits["eager"].abs().max()))
    check(bool(torch.isfinite(logits["cuda"]).all()),
          f"non-finite mixed logits of {cfg.name}")
    for key, bar in bars.items():
        check(err[key] <= bar, f"{cfg.name} mixed prefill {key} "
              f"{err[key]:.3e} > {bar:.3e}")
    return err


# ------------------------------------------------------------- the MoE ---

def moe_cfg():
    """llama4-scout-17b-a16e at full width and MOE_LAYERS of its layers."""
    return dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_LAYERS)


def moe_gemms(cfg) -> list[dict]:
    """The fused GEMMs one call of the MoE stack makes, as `lm_gemms`:
    each layer's q, k, v and o projections, the router (fp32 out), the
    shared expert's gate (silu), up and down, and the untied head; `leaf`
    is the weight's path in a layer's parameters (the head's in the
    parameters)."""
    d, q = cfg.d_model, cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    f = cfg.n_shared_experts * cfg.moe_d_ff
    layer = [("q", d, q, "linear", ("attn", "wq")),
             ("k", d, kv, "linear", ("attn", "wk")),
             ("v", d, kv, "linear", ("attn", "wv")),
             ("o", q, d, "linear", ("attn", "wo")),
             ("router", d, cfg.n_routed_experts, "linear",
              ("moe", "router")),
             ("gate", d, f, "silu", ("moe", "shared", "wg")),
             ("up", d, f, "linear", ("moe", "shared", "wu")),
             ("down", f, d, "linear", ("moe", "shared", "wd"))]
    out = [{"name": name, "k": k, "n": n, "act": act, "leaf": leaf,
            "per_dispatch": cfg.n_layers,
            "out_dtype": torch.float32 if name == "router" else None}
           for name, k, n, act, leaf in layer]
    return out + [{"name": "head", "k": d, "n": cfg.vocab_padded,
                   "act": "linear", "leaf": ("lm_head", "w"),
                   "per_dispatch": 1, "out_dtype": None}]


def moe_weights(params, g) -> list[torch.Tensor]:
    """The weights of GEMM `g` of `moe_gemms` in one call, layer by layer."""
    trees = ([params] if g["name"] == "head"
             else [lp for lp in params["layers"]])
    out = []
    for tree in trees:
        for key in g["leaf"]:
            tree = tree[key]
        out.append(tree)
    return out


def expert_shapes(cfg, rows: int) -> list[tuple]:
    """The three expert bmm launches of one layer at `rows` dispatch rows
    (B x capacity): (E, M, K, N) of wg, wu and wd."""
    e, d, f = cfg.n_routed_experts, cfg.d_model, cfg.moe_d_ff
    return [(e, rows, d, f), (e, rows, d, f), (e, rows, f, d)]


def moe_call_launches(cfg, b: int, s: int, attention: str) -> dict:
    """The kernel launches of one prefill (`attention` "flash_attention")
    or decode ("flash_decode") call of the MoE stack on b rows of s tokens:
    per layer the eight fused GEMMs of `moe_gemms`, the three expert bmm
    launches and one attention launch, then the head on one position a
    row; with the forward launches by regime."""
    want = dict.fromkeys(all_launches(), 0)
    n = cfg.n_layers
    want["gemm_fused_fwd"] = 8 * n + 1
    want["bmm_fwd"] = 3 * n
    want[attention] = n
    plans = [(ops.default_tiles(b if g["name"] == "head" else b * s,
                                g["k"], g["n"]), g["per_dispatch"])
             for g in moe_gemms(cfg)]
    plans += [(ops.bmm_plan_for(m, k, nn), n) for _, m, k, nn in
              expert_shapes(cfg, b * moe.capacity(s, cfg))]
    for plan, count in plans:
        want[f"gemm_fwd_regime_{plan.regime.lower()}"] += count
    return want


class RouteLog:
    """While active, records each MoE layer's routing as `moe_forward`
    computes it (expert ids and fp32 probabilities), by wrapping
    `models.moe.route`: one record per call in call order, or with
    `by_layer` one per layer, keyed by the layer's router tensor (the
    object, held here, so a train step's fresh leaves are new layers), in
    the order the layers first route.  Under remat a layer routes again
    when `torch.utils.checkpoint` recomputes it in the backward, in
    reverse layer order: by layer, that recompute is the same record,
    counted in `recomputed`, and must give the recorded expert ids."""

    def __init__(self, by_layer: bool = False):
        self.by_layer = by_layer

    def __enter__(self):
        self.calls, self.routers, self.recomputed = [], [], 0
        self._route = moe.route

        def route(engine, p, x, cfg):
            return self.take(p["router"], *self._route(engine, p, x, cfg))

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self._route

    def slot(self, router, idx, probs) -> tuple[int, bool]:
        """(the record of this routing, whether it is a recompute), adding
        the record of a new call or layer."""
        for i, r in enumerate(self.routers):
            if r is router:
                self.recomputed += 1
                return i, True
        self.calls.append((idx.clone(), probs.detach().clone()))
        if self.by_layer:
            self.routers.append(router)
        return len(self.calls) - 1, False

    def take(self, router, w, idx, probs):
        i, again = self.slot(router, idx, probs)
        check(not again or torch.equal(idx, self.calls[i][0]),
              f"layer {i} routed otherwise when recomputed")
        return w, idx, probs


class RouteReplay(RouteLog):
    """While active, each MoE layer takes the expert choice recorded in
    `calls` (a `RouteLog` of another engine's run, per call or per layer
    as `by_layer`, which must match): the router computes its own
    probabilities, which are recorded as `RouteLog` records them, with the
    engine's own top-k choice, and the layer runs the recorded experts
    weighted by its own probabilities of them, renormalised; by layer, a
    recompute takes its layer's recorded choice again.  So an engine
    follows another's routes and the two stay comparable where a near tie
    flips a route."""

    def __init__(self, calls, by_layer: bool = False):
        super().__init__(by_layer)
        self.replay = calls

    def take(self, router, w, idx, probs):
        i, _ = self.slot(router, idx, probs)
        check(len(self.calls) <= len(self.replay),
              f"{len(self.calls)} routings, {len(self.replay)} recorded")
        forced = self.replay[i][0]
        w = torch.gather(probs, -1, forced)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return w, forced, probs


def routing(cfg, replay=None):
    """The route recorder of a training run of `cfg` (by layer): a
    `RouteLog`, or with `replay` (another run's records) a `RouteReplay`;
    for a stack without MoE layers a context that records nothing."""
    if not n_moe_layers(cfg):
        return contextlib.nullcontext()
    return (RouteLog(by_layer=True) if replay is None
            else RouteReplay(replay, by_layer=True))


def n_moe_layers(cfg) -> int:
    """The MoE layers of a config's layer program."""
    return sum(n for kind, n in tfm.stack_program(cfg) if "moe" in kind)


def route_flips(cfg, cu_calls, ea_calls) -> tuple[list, list, float]:
    """Where `cuda` routed a token to other experts than `eager` (another
    set or another order of the top k): (the flips with eager's margin,
    the least gap between neighbours of its k + 1 largest probabilities,
    the rows with no flip, the routers' max-abs probability difference
    over those rows)."""
    check(len(cu_calls) == len(ea_calls),
          f"{len(cu_calls)} cuda routings, {len(ea_calls)} eager")
    n_moe = n_moe_layers(cfg)
    flips, flipped = [], set()
    for i, ((ic, _), (ie, pe)) in enumerate(zip(cu_calls, ea_calls)):
        for row, tok in (ic != ie).any(-1).nonzero().tolist():
            top = torch.topk(pe[row, tok], ic.shape[-1] + 1).values
            flips.append({"call": i // n_moe,
                          "layer": i % n_moe, "row": row,
                          "token": tok, "cuda": ic[row, tok].tolist(),
                          "eager": ie[row, tok].tolist(),
                          "eager_margin": float((top[:-1] - top[1:]).min())})
            flipped.add(row)
    rows = [r for r in range(cu_calls[0][0].shape[0]) if r not in flipped]
    prob_err = max((float((pc[rows] - pe[rows]).abs().max())
                    for (_, pc), (_, pe) in zip(cu_calls, ea_calls)
                    if rows), default=0.0)
    return flips, rows, prob_err


def route_ties(cfg, cu_calls, other_calls) -> dict:
    """Where another engine that ran `cuda`'s expert choices
    (`RouteReplay`) would itself have routed otherwise (`route_flips`),
    each flip allowed only where its margin is below MARGIN_FACTOR x the
    routers' max-abs probability difference over every row."""
    flips, _, _ = route_flips(cfg, cu_calls, other_calls)
    prob_err = max(float((pc - pe).abs().max()) for (_, pc), (_, pe)
                   in zip(cu_calls, other_calls))
    allowed = MARGIN_FACTOR * prob_err
    check(all(f["eager_margin"] < allowed for f in flips),
          f"{len(flips)} route flips, some at a clear margin (bar "
          f"{allowed:.3e}): {flips[:20]}")
    return {"route_flips": flips, "router_prob_max_abs_err": prob_err,
            "flip_allowed_below": allowed, "routes_compared": len(cu_calls)}


def check_bmm_fwd(e, m, k, n, gen) -> dict:
    """The batched forward at (E, M, K, N) against its plain version, fp32
    (within gemm_tol) and bf16, under the path's plan (`ops.bmm_plan_for`):
    every plan bitwise the path plan's, every batch slice the 2-D
    kernel's, a rerun bitwise.  Returns the errors."""
    dev = gen.device
    pick = ops.bmm_plan_for(m, k, n)
    worst, max_abs = {}, 0.0
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(e, m, k, generator=gen, device=dev).to(dt)
        w = (torch.randn(e, k, n, generator=gen, device=dev)
             / math.sqrt(k)).to(dt)
        got = gemm.bmm_fwd(x, w, plan=pick)
        plain = gemm.bmm_fwd_plain(x, w)
        where = f"bmm {(e, m, k, n)} {dt}"
        check(bool(torch.isfinite(got).all()), f"non-finite {where}")
        err = relmax(got, plain)
        tol = gemm_tol(k) if dt == torch.float32 else BF16_TOL
        check(err <= tol, f"{where}: {err:.3e} > {tol:g}")
        check(torch.equal(got, gemm.bmm_fwd(x, w, plan=pick)),
              f"two runs of {where} differ")
        for plan in gemm.PLANS:
            check(torch.equal(gemm.bmm_fwd(x, w, plan=plan), got),
                  f"{where}: plan {plan} differs from {pick}")
        for i in range(e):
            check(torch.equal(got[i], gemm.gemm_fused_fwd(x[i], w[i],
                                                          plan=pick)),
                  f"{where}: slice {i} differs from the 2-D kernel")
        worst[str(dt)] = err
        if dt == torch.float32:
            max_abs = float((got - plain).abs().max())
        del x, w, got, plain
    torch.cuda.empty_cache()
    return {"bmm": [e, m, k, n], "path_plan": list(pick), "relmax": worst,
            "max_abs_err_fp32": max_abs, "plans_bitwise_path_plan": True,
            "slices_bitwise_2d": True}


def check_moe_phase(cfg, cgen) -> dict:
    """Phase check_moe: the path's fused GEMMs at the MoE phases' rows
    (decode rows, moe_serve's slots, the prefill's tokens; the head at the
    decode rows only) against their plain versions with the path's plan,
    the router under every plan (each plan's bits the path plan's, fp32
    and bf16 operands, fp32 out); the expert bmm at the dispatch rows of
    the moe phases under every forward plan, each the path plan's bits,
    its batch slices the 2-D kernel's, reruns bitwise; the attention
    kernels at llama4's 40 / 8 heads of 128 (G = 5).  Returns the fp32
    max-abs errors at the moe_serve shapes."""
    b, s = MOE_PREFILL
    slots = MOE_SERVE["slots"]
    out = {"gemm": 0.0, "bmm": 0.0}
    for m in sorted({b, slots, b * s}):
        for g in moe_gemms(cfg):
            if g["name"] == "head" and m == b * s:
                continue  # the prefill's head reads its last position
            k, n = g["k"], g["n"]
            pick = ops.default_tiles(m, k, n)
            router = g["name"] == "router"
            res = check_shape(m, k, n, gemm.PLANS if router else (pick,),
                              cgen)
            if router:
                for dt in (torch.float32, torch.bfloat16):
                    x, w, _, _ = operands(m, k, n, dt, cgen)
                    want = gemm.gemm_fused_fwd(x, w, out_dtype=torch.float32,
                                               plan=pick)
                    for plan in gemm.PLANS:
                        check(torch.equal(gemm.gemm_fused_fwd(
                            x, w, out_dtype=torch.float32, plan=plan), want),
                            f"router {(m, k, n)} {dt}: plan {plan} differs "
                            f"from {pick}")
                res["plans_bitwise_path_plan"] = True
            if m == slots:
                out["gemm"] = max(out["gemm"], res["max_abs_err_fp32"])
            emit("check_moe", gemm=g["name"], path_plan=list(pick), **res)
    rows = sorted({b * 8, slots * 8, b * moe.capacity(s, cfg)})
    for m in rows:
        for e, _, k, n in expert_shapes(cfg, m)[1:]:
            res = check_bmm_fwd(e, m, k, n, cgen)
            if m == slots * 8:
                out["bmm"] = max(out["bmm"], res["max_abs_err_fp32"])
            emit("check_moe", plans=[list(p) for p in gemm.PLANS], **res)
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = cgen.device
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = qkv(b, s, s, h, kv, d, dt, cgen)
        err, mabs, n = check_attn_case(q, k, v, None, True)
        cases.append({"kernel": "flash_attention", "shape": [b, s, s, h, kv,
                                                             d],
                      "dtype": str(dt), "relmax": err, "max_abs": mabs,
                      "plan": list(fa.plan_for(b, s, h, kv)),
                      "plan_outputs_bitwise": n})
        for rows_, lens in ((b, [s + 1, s + 3]), (slots, [17, 40, 64, 80])):
            q, k, v = qkv(rows_, 1, MOE_CACHE, h, kv, d, dt, cgen)
            kvl = torch.tensor(lens, dtype=torch.int32, device=dev)
            err, mabs, splits, n, _ = check_decode_case(q, k, v, kvl, False)
            cases.append({"kernel": "flash_decode",
                          "shape": [rows_, 1, MOE_CACHE, h, kv, d],
                          "dtype": str(dt), "relmax": err, "max_abs": mabs,
                          "splits": splits})
        del q, k, v
    torch.cuda.synchronize()
    emit("check_moe", arch=cfg.name, attention=cases, group=h // kv)
    return out


def moe_params(cfg, dev):
    """Full-width random parameters from a seed, drawn on the card."""
    gen = torch.Generator(device=dev).manual_seed(23)
    return tfm.init_params(cfg, generator=gen, device=dev)


def moe_phase(cfg, params, dev) -> dict:
    """Phase moe: the prefill of MOE_PREFILL and MOE_DECODE_STEPS decode
    steps on `cuda` and on `eager` from one parameter dict, routes first;
    returns the logits max-abs error over the rows with no route flip."""
    b, s = MOE_PREFILL
    rng = np.random.default_rng(24)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(dev)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (MOE_DECODE_STEPS, b, 1))).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    with torch.inference_mode():
        for label in ("cuda", "eager"):
            eng = make_engine(label, device=dev)
            prefill, decode = (make_prefill_step(eng, cfg),
                               make_decode_step(eng, cfg))
            torch.cuda.synchronize()
            reset_all_launches()
            with RouteLog() as routes:
                logits, caches = prefill(params, {"tokens": tokens})
                torch.cuda.synchronize()
                pre = {"launches": all_launches(),
                       "dispatch": backends.dispatch_counts()}
                buf = kvcache.cache_init(cfg, b, MOE_CACHE, device=dev)
                kvcache.copy_prefill(cfg, buf, caches, s)
                reset_all_launches()
                dlogits = []
                for t in range(MOE_DECODE_STEPS):
                    lg, buf = decode(params, buf, feed[t],
                                     torch.tensor(s + t, device=dev))
                    dlogits.append(lg)
                torch.cuda.synchronize()
            out[label] = {"logits": logits, "caches": caches, "buf": buf,
                          "dlogits": torch.stack(dlogits), "pre": pre,
                          "dec": {"launches": all_launches(),
                                  "dispatch": backends.dispatch_counts()},
                          "routes": routes.calls}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    cu, ea = out["cuda"], out["eager"]
    flips, rows, prob_err = route_flips(cfg, cu["routes"], ea["routes"])
    allowed = MARGIN_FACTOR * prob_err
    check(bool(rows), f"every row flipped a route: {flips}")
    errs = {"prefill_logits": relmax(cu["logits"][rows], ea["logits"][rows]),
            "decode_logits": relmax(cu["dlogits"][:, rows],
                                    ea["dlogits"][:, rows])}
    for name in ("k", "v"):
        errs[f"prefill_{name}_cache"] = relmax(cu["caches"][0][name][:, rows],
                                               ea["caches"][0][name][:, rows])
        errs[f"decode_{name}_cache"] = relmax(cu["buf"][0][name][:, rows],
                                              ea["buf"][0][name][:, rows])
    abs_err = max(
        float((cu["logits"][rows] - ea["logits"][rows]).abs().max()),
        float((cu["dlogits"][:, rows] - ea["dlogits"][:, rows]).abs().max()))
    want_pre = moe_call_launches(cfg, b, s, "flash_attention")
    want_dec = {k: MOE_DECODE_STEPS * v for k, v in
                moe_call_launches(cfg, b, 1, "flash_decode").items()}
    einsums = 3 * cfg.n_layers
    emit("moe", arch=cfg.name, layers=cfg.n_layers, of_layers=get_arch(
        MOE_ARCH).n_layers, d_model=cfg.d_model, experts=cfg.n_routed_experts,
         prefill=[b, s], decode_steps=MOE_DECODE_STEPS, cache_rows=MOE_CACHE,
         capacity={"prefill": moe.capacity(s, cfg),
                   "decode": moe.capacity(1, cfg)},
         relmax=errs, logits_max_abs_err=abs_err,
         logits_max_abs=float(ea["logits"].abs().max()),
         route_flips=flips, rows_compared=rows,
         router_prob_max_abs_err=prob_err,
         flip_allowed_below=allowed, routings=len(cu["routes"]),
         launches_prefill=cu["pre"]["launches"], want_prefill=want_pre,
         launches_decode=cu["dec"]["launches"], want_decode=want_dec,
         dispatch_prefill={f"{bk}.{o}": c for (bk, o), c
                           in cu["pre"]["dispatch"].items()},
         peak_gb=peak_gb,
         param_gb=sum(t.numel() * t.element_size()
                      for t in flatten(params).values()) / 1e9)
    check(all(f["eager_margin"] < allowed for f in flips),
          f"a route flipped at a clear margin (bar {allowed:.3e}): {flips}")
    for key, err in errs.items():
        check(math.isfinite(err) and err <= LOGIT_TOL,
              f"moe {key} cuda vs eager {err:.3e} > {LOGIT_TOL:g}")
    check(cu["pre"]["launches"] == want_pre,
          f"moe prefill launches {cu['pre']['launches']}, want {want_pre}")
    check(cu["dec"]["launches"] == want_dec,
          f"moe decode launches {cu['dec']['launches']}, want {want_dec}")
    for part, calls in (("pre", 1), ("dec", MOE_DECODE_STEPS)):
        disp = cu[part]["dispatch"]
        check(all(bk == "cuda" for bk, _ in disp)
              and disp.get(("cuda", "einsum")) == calls * einsums,
              f"moe {part} dispatches {disp}")
        check(sum(ea[part]["launches"].values()) == 0,
              "the eager engine launched a kernel of the port")
    return {"abs_err": abs_err, "errs": errs, "peak_gb": peak_gb}


def moe_serve_phase(cfg, params, dev, abs_err) -> dict:
    """Phase moe_serve: the MoE main path, the slot engine on `cuda`, then
    the same requests on `eager` on the card."""
    kw = {"slots": MOE_SERVE["slots"], "max_len": MOE_SERVE["max_len"]}
    reqs = requests(cfg, MOE_SERVE["requests"], 25, MOE_SERVE["prompt"],
                    MOE_SERVE["new"])
    server = ServingEngine(cfg, params, engine=make_engine("cuda"), **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    t0 = time.perf_counter()
    server.run(reqs)  # ---- the MoE main path, driven once
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    dispatch = backends.dispatch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    st = server.stats()
    want = {k: st["steps"] * v for k, v in moe_call_launches(
        cfg, kw["slots"], 1, "flash_decode").items()}
    ereqs = requests(cfg, MOE_SERVE["requests"], 25, MOE_SERVE["prompt"],
                     MOE_SERVE["new"])
    t1 = time.perf_counter()
    ServingEngine(cfg, params, engine=make_engine("eager", device=dev),
                  **kw).run(ereqs)
    eager_wall = time.perf_counter() - t1
    head = tfm.head_weight(params, cfg)
    eager = make_engine("eager", device=dev)
    mismatches = []
    for a, e in zip(reqs, ereqs):
        if a.out == e.out:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a.out, e.out)) if x != y)
        with torch.inference_mode():
            h, _ = tfm.forward_hidden(eager, cfg, params, tokens=torch.tensor(
                [e.prompt + e.out[:j]], device=dev))
            top2 = torch.topk(h[0, -1] @ head, 2).values
        mismatches.append({"rid": a.rid, "token": j,
                           "eager_margin": float(top2[0] - top2[1]),
                           "allowed_below": MARGIN_FACTOR * abs_err})
    emit("moe_serve", arch=cfg.name, layers=cfg.n_layers,
         requests=len(reqs), completed=st["requests"]["completed"],
         rejected=st["requests"]["rejected"], tokens=st["tokens"],
         prompt_tokens=sum(len(r.prompt) for r in reqs), steps=st["steps"],
         wall_s=wall, eager_wall_s=eager_wall,
         tokens_per_s=st["throughput"], p50_ms=st["latency_s"]["p50"] * 1e3,
         p99_ms=st["latency_s"]["p99"] * 1e3, peak_gb=peak_gb,
         launches=launches, want_launches=want,
         engine_dispatch={f"{b}.{o}": c for (b, o), c in dispatch.items()},
         op_counts={f"{b}.{o}": c for (b, o), c in st["op_counts"].items()},
         mismatches=mismatches, n_mismatches=len(mismatches))
    check(st["requests"]["completed"] == len(reqs)
          and st["requests"]["rejected"] == 0
          and all(r.done and len(r.out) == r.max_new for r in reqs),
          f"{st['requests']['completed']} of {len(reqs)} completed")
    check(launches == want, f"moe_serve launches {launches}, want {want}")
    check(all(b == "cuda" for b, _ in dispatch),
          f"an engine op left the cuda backend: {dispatch}")
    check(all(e.done for e in ereqs), "an eager request did not complete")
    check(all(m["eager_margin"] < m["allowed_below"] for m in mismatches),
          f"moe cuda vs eager token mismatch at a clear margin: "
          f"{mismatches}")
    return {"launches": launches, "stats": st, "wall_s": wall,
            "peak_gb": peak_gb}


def timing_moe_phase(cfg, params, dev, cgen, peak_flops, peak_bw, smi,
                     serve) -> dict:
    """Phase timing_moe: a moe_serve decode step's host ms on `cuda` and
    `eager`, its device ms by kernel (torch.profiler) and busy share; the
    three expert bmm launches of one layer at MOE_BMM_ROWS rows, each
    kernel, plain, torch.bmm (TF32 off) and bound ms; the fused GEMMs of
    one moe_serve decode dispatch over the parameters' own weights; the
    attention kernels at 40 / 8 heads of 128 (G = 5): the flash forward at
    the moe prefill, the decode kernel at a moe_serve decode step."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off")
    slots = MOE_SERVE["slots"]
    caches = kvcache.cache_init(cfg, slots, MOE_SERVE["max_len"], device=dev)
    tok = torch.ones((slots, 1), dtype=torch.int64, device=dev)
    pos = torch.tensor([16, 40, 64, 90], device=dev)
    step = {}
    with torch.inference_mode():
        for label in ("cuda", "eager"):
            decode = make_decode_step(make_engine(label, device=dev), cfg)
            step[f"{label}_host_ms"] = host_ms(
                lambda: decode(params, caches, tok, pos))
        decode = make_decode_step(make_engine("cuda"), cfg)
        by_kernel = time_ssd.device_time_by_kernel(
            lambda: decode(params, caches, tok, pos))
    step["cuda_device_ms"] = sum(r["ms"] for r in by_kernel.values())
    step["busy_share"] = step["cuda_device_ms"] / step["cuda_host_ms"]
    emit("timing_moe_step", smi=smi, arch=cfg.name, slots=slots, **step,
         top_kernels=dict(list(by_kernel.items())[:12]),
         serve_tokens_per_s=serve["stats"]["throughput"])
    del caches
    lp = params["layers"][0]["moe"]
    rows = {}
    for name, m in MOE_BMM_ROWS.items():
        row = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                             "ops_ms", "bytes_ms"), 0.0)
        launches = []
        for (e, _, k, n), w in zip(expert_shapes(cfg, m),
                                   (lp["wg"], lp["wu"], lp["wd"])):
            x = torch.randn(e, m, k, generator=cgen, device=dev)
            plan = ops.bmm_plan_for(m, k, n)
            flops = 2.0 * e * m * k * n
            nbytes = 4.0 * (e * m * k + e * k * n + e * m * n)
            one = {"ms": cuda_ms(lambda: gemm.bmm_fwd(x, w, plan=plan),
                                 reps=5, repeats=3),
                   "plain_ms": cuda_ms(lambda: gemm.bmm_fwd_plain(x, w),
                                       reps=5, repeats=3),
                   "library_ms": cuda_ms(lambda: torch.bmm(x, w), reps=5,
                                         repeats=3),
                   "bound_ms": bound(flops, nbytes, peak_flops, peak_bw)[0],
                   "ops_ms": flops / peak_flops * 1e3,
                   "bytes_ms": nbytes / peak_bw * 1e3}
            for key, val in one.items():
                row[key] += val
            launches.append({"shape": [e, m, k, n], "plan": list(plan),
                             **one, "bound_share": one["bound_ms"]
                             / one["ms"]})
            del x
        row["bound_by"] = ("operations" if row["ops_ms"] >= row["bytes_ms"]
                           else "bytes")
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[name] = row
        emit("timing_moe", kernel="bmm_fwd", smi=smi, rows_name=name,
             dispatch_rows=m, launches=launches, **row)
    gem = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                         "ops_ms", "bytes_ms"), 0.0)
    per = {}
    for g in moe_gemms(cfg):
        k, n, act, odt = g["k"], g["n"], g["act"], g["out_dtype"]
        ws = moe_weights(params, g)
        x = torch.randn(slots, k, generator=cgen, device=dev)
        plan = ops.default_tiles(slots, k, n)
        flops = 2.0 * slots * k * n * len(ws)
        nbytes = 4.0 * (slots * k + k * n + slots * n) * len(ws)

        def run(fn):
            return lambda: [fn(w) for w in ws]

        one = {"ms": cuda_ms(run(lambda w: gemm.gemm_fused_fwd(
                   x, w, act=act, out_dtype=odt, plan=plan)), reps=5),
               "plain_ms": cuda_ms(run(lambda w: gemm.gemm_fused_plain(
                   x, w, act=act, out_dtype=odt)), reps=5),
               "library_ms": cuda_ms(run(lambda w: torch.matmul(x, w)),
                                     reps=5),
               "bound_ms": bound(flops, nbytes, peak_flops, peak_bw)[0],
               "ops_ms": flops / peak_flops * 1e3,
               "bytes_ms": nbytes / peak_bw * 1e3}
        for key, val in one.items():
            gem[key] += val
        per[g["name"]] = {**one, "plan": list(plan), "launches": len(ws)}
        del x
    gem["bound_by"] = ("operations" if gem["ops_ms"] >= gem["bytes_ms"]
                       else "bytes")
    emit("timing_moe", kernel="gemm_fused_fwd", smi=smi, rows=slots,
         dispatch=per, **gem)
    b, s = MOE_PREFILL
    attn = attn_timing_rows(cfg, {
        "moe_prefill": (b, s, s, None, True),
        "moe_serve_decode": (slots, 1, MOE_SERVE["max_len"], [16, 40, 64, 90],
                             False)}, cgen, peak_flops, peak_bw, smi,
        "timing_moe")
    return {"bmm": rows, "gemm": gem, "step": step, "attention": attn}


# ------------------------------------------------------- the frontends ---

def frontend_gemms(cfg) -> list[dict]:
    """The GEMMs one forward of a frontend config runs, as `lm_gemms`:
    each layer's projections (SwiGLU's gate, up and down for silu, else
    the plain MLP's up with its activation and down), the projector (the
    vision MLP's two layers with their biases as the shift and gelu after
    the first, or the audio Linear) and the untied head; `rows` names
    which rows each runs on ("layer", "frontend", "head")."""
    d, q = cfg.d_model, cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    mlp = ([("gate", d, cfg.d_ff, "silu"), ("up", d, cfg.d_ff, "linear")]
           if cfg.act == "silu" else [("up", d, cfg.d_ff, cfg.act)])
    layer = [("q", d, q, "linear"), ("k", d, kv, "linear"),
             ("v", d, kv, "linear"), ("o", q, d, "linear"), *mlp,
             ("down", cfg.d_ff, d, "linear")]
    out = [{"name": name, "k": k, "n": n, "act": act, "shift": False,
            "per_dispatch": cfg.n_layers, "rows": "layer"}
           for name, k, n, act in layer]
    fd = cfg.frontend_dim
    if cfg.frontend == "vision":
        out += [{"name": "projector_1", "k": fd, "n": d, "act": "gelu",
                 "shift": True, "per_dispatch": 1, "rows": "frontend",
                 "param": "w1"},
                {"name": "projector_2", "k": d, "n": d, "act": "linear",
                 "shift": True, "per_dispatch": 1, "rows": "frontend",
                 "param": "w2"}]
    else:
        out.append({"name": "projection", "k": fd, "n": d, "act": "linear",
                    "shift": True, "per_dispatch": 1, "rows": "frontend",
                    "param": "w"})
    return out + [{"name": "head", "k": d, "n": cfg.vocab_padded,
                   "act": "linear", "shift": False, "per_dispatch": 1,
                   "rows": "head"}]


def frontend_call_launches(cfg, rows: dict, attention: str) -> dict:
    """The kernel launches of one prefill or forward (`rows` {"layer",
    "frontend", "head"}: the rows each GEMM kind runs on, "frontend" None
    for a decode step) of a frontend config: its GEMMs (`frontend_gemms`)
    with the forward launches by regime, and one `attention` launch a
    layer."""
    want = dict.fromkeys(all_launches(), 0)
    for g in frontend_gemms(cfg):
        m = rows[g["rows"]]
        if m is None:
            continue
        plan = ops.default_tiles(m, g["k"], g["n"])
        want["gemm_fused_fwd"] += g["per_dispatch"]
        want[f"gemm_fwd_regime_{plan.regime.lower()}"] += g["per_dispatch"]
    want[attention] = cfg.n_layers
    return want


def frontend_params(cfg, dev, seed):
    """Full-width, full-depth random parameters from a seed, drawn on the
    card, with random projector biases and layer-norm parameters (the
    init's zeros and ones would leave the shift epilogue untested)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tfm.init_params(cfg, generator=gen, device=dev)
    fe = params["frontend"]
    with torch.no_grad():
        for t in [fe["ln"]["scale"], fe["ln"]["bias"],
                  *(fe[k] for k in ("b1", "b2", "b") if k in fe)]:
            t.add_(torch.randn(t.shape, generator=gen, device=dev) * 0.1)
    return params


class AttnLog:
    """While active, records the head dim and the causal flag of every
    launch of the flash forward's wrapper (wrapping
    `flash_attention.flash_attention_fwd`, which `ops.attention` calls)."""

    def __enter__(self):
        self.calls = []
        self._fwd = fa.flash_attention_fwd

        def fwd(q, k, v, kv_len=None, *, causal=True, **kw):
            self.calls.append((q.shape[-1], causal))
            return self._fwd(q, k, v, kv_len, causal=causal, **kw)

        fa.flash_attention_fwd = fwd
        return self

    def __exit__(self, *exc):
        fa.flash_attention_fwd = self._fwd


def check_attn_cases(cfg, cgen, cases) -> tuple[list, dict]:
    """The flash forward ("attn") and the split-KV decode ("decode") at
    the config's heads at `cases` [(kind, name, (b, sq, skv, kv_len list
    or None, causal))], fp32 and bf16, as phases 9-10: every forward plan
    bitwise the path plan's, the merged decode bitwise `combine`, the
    one-split decode bitwise the forward.  Returns the rows and the fp32
    max-abs errors by kind."""
    dev = cgen.device
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows, worst = [], {"attn": 0.0, "decode": 0.0}
    for kind, name, (b, sq, skv, lens, causal) in cases:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(b, sq, skv, h, kv, d, dt, cgen)
            kvl = (None if lens is None else
                   torch.tensor(lens, dtype=torch.int32, device=dev))
            if kind == "attn":
                err, mabs, n = check_attn_case(q, k, v, kvl, causal)
                extra = {"plan": list(fa.plan_for(b, sq, h, kv, d)),
                         "plan_outputs_bitwise": n}
            else:
                err, mabs, splits, n, _ = check_decode_case(q, k, v, kvl,
                                                            causal)
                extra = {"splits": splits, "merge_outputs_bitwise": n}
            if dt == torch.float32:
                worst[kind] = max(worst[kind], mabs)
            rows.append({"kernel": kind, "shape": name,
                         "dims": [b, sq, skv, h, kv, d], "causal": causal,
                         "dtype": str(dt), "relmax": err, "max_abs": mabs,
                         **extra})
            del q, k, v
    torch.cuda.synchronize()
    return rows, worst


def check_frontends_phase(cfg, cgen, rows: dict, attn_cases: dict,
                          decode_cases: dict) -> dict:
    """Phase check_frontends: a frontend config's projector GEMMs and head
    at the rows its phases give them (`rows`), each against its plain
    version as phase 2 with the path's plan; the attention kernels at its
    heads (`attn_cases`, `decode_cases`: {name: (b, sq, skv, kv_len list
    or None, causal)}), fp32 and bf16, as phases 9-10.  Returns the fp32
    max-abs errors by kernel."""
    out = {"gemm": 0.0}
    gemms = []
    for g in frontend_gemms(cfg):
        if g["rows"] == "layer":
            continue
        m = rows[g["rows"]]
        res = check_shape(m, g["k"], g["n"],
                          (ops.default_tiles(m, g["k"], g["n"]),), cgen)
        out["gemm"] = max(out["gemm"], res["max_abs_err_fp32"])
        gemms.append({"gemm": g["name"], **res})
    cases, worst = check_attn_cases(cfg, cgen, [
        *(("attn", name, c) for name, c in attn_cases.items()),
        *(("decode", name, c) for name, c in decode_cases.items())])
    out.update(worst)
    emit("check_frontends", arch=cfg.name, gemms=gemms, attention=cases,
         max_abs_err=out)
    return out


def cache_relmax(cfg, got, want, s=None) -> dict:
    """The max-relative error of each cache leaf, in one walk over
    `kvcache.cache_init`'s layout (the program's entries): a dense entry's
    K / V as one relmax over its stacked layers (`k_cache`, `v_cache`);
    every other leaf the worst per-layer relmax: a super entry's mamba
    leaves (`super.<leaf>`) and shared K / V (`shared.<leaf>`), a mamba
    tail's leaves (`tail.<leaf>`), the MLA entries' latent (`c_kv`,
    `k_rope`, worst over the entries).  K / V and latent rows over [0, s)
    when `s` is given."""
    errs = {}

    def worst(name, pairs):
        errs[name] = max([errs.get(name, 0.0)] + [relmax(g, w)
                                                  for g, w in pairs])

    for (kind, n), g, w in zip(tfm.stack_program(cfg), got, want):
        if kind == "zamba_super":
            for name, t in w["mamba"].items():
                worst(f"super.{name}", ((g["mamba"][name][i, j], t[i, j])
                                        for i in range(n)
                                        for j in range(cfg.attn_every)))
            for name, t in w["shared"].items():
                worst(f"shared.{name}", ((g["shared"][name][i, :, :s],
                                          t[i, :, :s]) for i in range(n)))
        elif kind == "mamba":
            for name, t in w.items():
                worst(f"tail.{name}", ((g[name][i], t[i]) for i in range(n)))
        elif kind in ("mla_dense", "mla_moe"):
            for name, t in w.items():
                worst(name, ((g[name][i, :, :s], t[i, :, :s])
                             for i in range(n)))
        else:
            for name, t in w.items():
                worst(f"{name}_cache", [(g[name][:, :, :s], t[:, :, :s])])
    return errs


def replayed_routes(cfg, cu, ea, steps) -> dict:
    """For a MoE stack in `prefill_decode_phase`, where `eager` ran
    `cuda`'s expert choices (`RouteReplay`): `route_ties` over the prefill
    and the decode steps both engines ran on the same tokens."""
    same = (cu["tokens"] == ea["tokens"]).all(0)
    j = int(same.logical_not().nonzero()[0]) if not bool(same.all()) \
        else len(same)
    calls = n_moe_layers(cfg) * (1 + min(j, steps))
    return route_ties(cfg, cu["routes"][:calls], ea["routes"][:calls])


def prefill_decode_phase(phase, cfg, params, dev, inputs, s, steps,
                         want_pre, want_dec,
                         strict_tokens=False, routed=False,
                         **fields) -> dict:
    """Phase `phase` for a decoder at full width: a prefill of `inputs`
    (`s` positions) through `make_prefill_step`, then `steps` greedy
    decode steps through `make_decode_step` on caches from
    `kvcache.cache_init` (s + steps rows, filled by
    `kvcache.copy_prefill`), on `cuda` and on `eager`, each from its own
    greedy tokens, the launch counts set to 0 just before each part.
    Checks `cuda` against `eager`: logits over the real vocabulary and
    the caches (`cache_relmax(cfg, got, want, rows)`, {leaf: relmax}) within
    LOGIT_TOL while the tokens agree; the tokens equal (`strict_tokens`),
    or else differing first where eager's top-2 margin is below
    MARGIN_FACTOR x the logits error; the launches of a prefill
    (`want_pre`) and of a step (`want_dec`) exactly, every flash forward
    at (head dim, causal); every op on `cuda`, `eager` launching none.
    With `routed` (a MoE stack) `cuda`'s routes are logged and `eager`
    runs them (`RouteReplay`), each route its own router chose otherwise
    checked to be a near tie (`replayed_routes`).
    Emits the line with `fields`; returns the errors and the `cuda`
    launches."""
    b = inputs["tokens"].shape[0]
    rows = s + steps
    torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    with torch.inference_mode():
        for label in ("cuda", "eager"):
            eng = make_engine(label, device=dev)
            prefill, decode = (make_prefill_step(eng, cfg),
                               make_decode_step(eng, cfg))
            torch.cuda.synchronize()
            reset_all_launches()
            with (contextlib.nullcontext() if not routed else RouteLog()
                  if label == "cuda" else
                  RouteReplay(out["cuda"]["routes"])) as rl:
                with AttnLog() as attn_calls:
                    t0 = time.perf_counter()
                    logits, caches = prefill(params, inputs)
                    torch.cuda.synchronize()
                    host = (time.perf_counter() - t0) * 1e3
                pre = {"launches": all_launches(),
                       "dispatch": backends.dispatch_counts(),
                       "host_ms": host, "attn": attn_calls.calls}
                buf = kvcache.cache_init(cfg, b, rows, device=dev)
                kvcache.copy_prefill(cfg, buf, caches, s)
                reset_all_launches()
                toks, dlogits = [greedy_sample(logits)], []
                t0 = time.perf_counter()
                for t in range(steps):
                    lg, buf = decode(params, buf, toks[-1][:, None].long(),
                                     torch.tensor(s + t, device=dev))
                    dlogits.append(lg)
                    toks.append(greedy_sample(lg))
                torch.cuda.synchronize()
            dec = {"launches": all_launches(),
                   "dispatch": backends.dispatch_counts(),
                   "host_ms": (time.perf_counter() - t0) * 1e3 / steps}
            out[label] = {"logits": logits, "caches": caches, "buf": buf,
                          "dlogits": torch.stack(dlogits),
                          "tokens": torch.stack(toks, 1), "pre": pre,
                          "dec": dec}
            if routed:
                out[label]["routes"] = rl.calls
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    cu, ea = out["cuda"], out["eager"]
    check(tuple(cu["logits"].shape) == (b, 1, cfg.vocab_padded)
          and tuple(cu["dlogits"].shape) == (steps, b, 1, cfg.vocab_padded),
          f"{phase} logits {tuple(cu['logits'].shape)}, "
          f"{tuple(cu['dlogits'].shape)}")
    for run in (cu, ea):  # the padded vocab columns hold -1e30: cut them
        run["logits"] = run["logits"][..., :cfg.vocab_size]
        run["dlogits"] = run["dlogits"][..., :cfg.vocab_size]
    check(bool(torch.isfinite(cu["logits"]).all()
               and torch.isfinite(cu["dlogits"]).all()),
          f"non-finite {phase} logits")
    if routed:
        fields.update(replayed_routes(cfg, cu, ea, steps))
    same = (cu["tokens"] == ea["tokens"]).all(0)      # (steps + 1,)
    j = int(same.logical_not().nonzero()[0]) if not bool(same.all()) \
        else len(same)
    # decode step t ran on the tokens 0..t: the same in both while t < j
    errs = {"prefill_logits": relmax(cu["logits"], ea["logits"]),
            "decode_logits": (relmax(cu["dlogits"][:j], ea["dlogits"][:j])
                              if j else 0.0)}
    errs.update({f"prefill_{k}": v for k, v in
                 cache_relmax(cfg, cu["caches"], ea["caches"]).items()})
    errs.update({f"decode_{k}": v for k, v in
                 cache_relmax(cfg, cu["buf"], ea["buf"], s + j).items()})
    abs_err = max(float((cu["logits"] - ea["logits"]).abs().max()),
                  float((cu["dlogits"][:j] - ea["dlogits"][:j]).abs().max())
                  if j else 0.0)
    top2 = torch.topk(torch.cat([ea["logits"], *ea["dlogits"]], 1), 2).values
    mismatch = None
    if j <= steps:
        lg = ea["logits"] if j == 0 else ea["dlogits"][j - 1]
        top2_j = torch.topk(lg[:, -1], 2).values
        mismatch = {"token": j, "eager_margin": float(
            (top2_j[:, 0] - top2_j[:, 1]).min()),
            "allowed_below": MARGIN_FACTOR * abs_err}
    want_dec = {k: steps * v for k, v in want_dec.items()}
    emit(phase, arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         heads=[cfg.n_heads, cfg.n_kv_heads, cfg.head_dim], batch=b,
         **fields, decode_steps=steps, cache_rows=rows, relmax=errs,
         logits_max_abs_err=abs_err,
         logits_max_abs=float(ea["logits"].abs().max()),
         tokens_equal=mismatch is None, mismatch=mismatch,
         tokens=cu["tokens"].tolist(),
         eager_min_top2_margin=float((top2[..., 0] - top2[..., 1]).min()),
         launches_prefill=cu["pre"]["launches"], want_prefill=want_pre,
         launches_decode=cu["dec"]["launches"], want_decode=want_dec,
         attention_launches=sorted(set(cu["pre"]["attn"])),
         dispatch_prefill={f"{bk}.{o}": c for (bk, o), c
                           in cu["pre"]["dispatch"].items()},
         prefill_host_ms=cu["pre"]["host_ms"],
         decode_step_host_ms=cu["dec"]["host_ms"],
         eager_prefill_host_ms=ea["pre"]["host_ms"],
         eager_decode_step_host_ms=ea["dec"]["host_ms"], peak_gb=peak_gb,
         param_gb=sum(t.numel() * t.element_size()
                      for t in flatten(params).values()) / 1e9)
    if strict_tokens:
        check(mismatch is None, f"{phase} greedy tokens differ: cuda "
              f"{cu['tokens'].tolist()}, eager {ea['tokens'].tolist()}")
    check(mismatch is None or mismatch["eager_margin"]
          < mismatch["allowed_below"],
          f"{phase} greedy tokens differ at a clear margin: {mismatch}")
    for key, err in errs.items():
        check(math.isfinite(err) and err <= LOGIT_TOL,
              f"{phase} {key} cuda vs eager {err:.3e} > {LOGIT_TOL:g}")
    check(cu["pre"]["launches"] == want_pre,
          f"{phase} prefill launches {cu['pre']['launches']}, want "
          f"{want_pre}")
    check(cu["dec"]["launches"] == want_dec,
          f"{phase} decode launches {cu['dec']['launches']}, want "
          f"{want_dec}")
    check(cu["pre"]["attn"] == [(cfg.head_dim, True)]
          * want_pre["flash_attention"],
          f"{phase} prefill attention launches {cu['pre']['attn']}")
    for part in ("pre", "dec"):
        check(all(bk == "cuda" for bk, _ in cu[part]["dispatch"]),
              f"{phase} {part} dispatches {cu[part]['dispatch']}")
        check(sum(ea[part]["launches"].values()) == 0
              and not ea["pre"]["attn"],
              "the eager engine launched a kernel of the port")
    launches = {k: cu["pre"]["launches"][k] + cu["dec"]["launches"][k]
                for k in cu["pre"]["launches"]}
    return {"abs_err": abs_err, "errs": errs, "launches": launches,
            "peak_gb": peak_gb}


def vlm_phase(cfg, params, dev) -> dict:
    """Phase vlm: internvl2-2b at full width and depth, a prefill of
    VLM_PREFILL requests (256 patch embeddings and the text tokens) and
    VLM_DECODE_STEPS greedy decode steps against their caches (the
    split-KV decode kernel), through `prefill_decode_phase`."""
    b, text = VLM_PREFILL
    s = cfg.frontend_tokens + text
    gen = torch.Generator(device=dev).manual_seed(31)
    inputs = input_tensors(cfg, ShapeConfig("vlm", s, b, "prefill"),
                           generator=gen, device=dev)
    want_pre = frontend_call_launches(
        cfg, {"layer": b * s, "frontend": b * cfg.frontend_tokens,
              "head": b}, "flash_attention")
    want_dec = frontend_call_launches(
        cfg, {"layer": b, "frontend": None, "head": b}, "flash_decode")
    return prefill_decode_phase(
        "vlm", cfg, params, dev, inputs, s, VLM_DECODE_STEPS, want_pre,
        want_dec, patches=cfg.frontend_tokens, text_tokens=text)


def audio_phase(cfg, params, dev) -> dict:
    """Phase audio: hubert-xlarge at full width and depth, `make_forward_step`
    over frames AUDIO_FRAMES on `cuda` and on `eager`, the launch counts set
    to 0 just before; every attention launch at head dim 80, not causal.
    Returns the errors and the `cuda` launches."""
    b, s = AUDIO_FRAMES
    gen = torch.Generator(device=dev).manual_seed(41)
    inputs = input_tensors(cfg, ShapeConfig("audio", s, b, "prefill"),
                           generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    with torch.inference_mode():
        for label in ("cuda", "eager"):
            forward = make_forward_step(make_engine(label, device=dev), cfg)
            torch.cuda.synchronize()
            reset_all_launches()
            with AttnLog() as attn_calls:
                t0 = time.perf_counter()
                logits = forward(params, inputs)
                torch.cuda.synchronize()
                host = (time.perf_counter() - t0) * 1e3
            out[label] = {"logits": logits, "launches": all_launches(),
                          "dispatch": backends.dispatch_counts(),
                          "host_ms": host, "attn": attn_calls.calls}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    cu, ea = out["cuda"], out["eager"]
    check(tuple(cu["logits"].shape) == (b, 1, cfg.vocab_padded),
          f"audio logits {tuple(cu['logits'].shape)}")
    for run in (cu, ea):  # the padded vocab columns hold -1e30: cut them
        run["logits"] = run["logits"][..., :cfg.vocab_size]
    err = relmax(cu["logits"], ea["logits"])
    abs_err = float((cu["logits"] - ea["logits"]).abs().max())
    want = frontend_call_launches(cfg, {"layer": b * s, "frontend": b * s,
                                        "head": b}, "flash_attention")
    emit("audio", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         heads=[cfg.n_heads, cfg.n_kv_heads, cfg.head_dim], frames=[b, s],
         causal=cfg.causal, logits_relmax=err, logits_max_abs_err=abs_err,
         logits_max_abs=float(ea["logits"].abs().max()),
         logits_shape=list(cu["logits"].shape),
         launches=cu["launches"], want_launches=want,
         attention_launches=sorted(set(cu["attn"])),
         dispatch={f"{bk}.{o}": c for (bk, o), c in cu["dispatch"].items()},
         host_ms=cu["host_ms"], eager_host_ms=ea["host_ms"], peak_gb=peak_gb,
         param_gb=sum(t.numel() * t.element_size()
                      for t in flatten(params).values()) / 1e9)
    check(bool(torch.isfinite(cu["logits"]).all()), "non-finite audio logits")
    check(math.isfinite(err) and err <= LOGIT_TOL,
          f"audio logits cuda vs eager {err:.3e} > {LOGIT_TOL:g}")
    check(cu["launches"] == want,
          f"audio launches {cu['launches']}, want {want}")
    check(cu["attn"] == [(cfg.head_dim, False)] * cfg.n_layers,
          f"audio attention launches {cu['attn']}")
    check(all(bk == "cuda" for bk, _ in cu["dispatch"]),
          f"audio dispatches {cu['dispatch']}")
    check(sum(ea["launches"].values()) == 0 and not ea["attn"],
          "the eager engine launched a kernel of the port")
    return {"abs_err": abs_err, "err": err, "launches": cu["launches"],
            "peak_gb": peak_gb}


def step_breakdown(name, fn, smi, cfg, phase="timing_frontends",
                   **extra) -> dict:
    """Host ms (median of 3 synchronised calls), device ms by kernel name
    (torch.profiler) and the busy share of one call of `fn`, emitted as a
    `phase` line."""
    host = host_ms(fn, reps=3)
    by_kernel = time_ssd.device_time_by_kernel(fn)
    device = sum(r["ms"] for r in by_kernel.values())
    row = {"host_ms": host, "device_ms": device, "busy_share": device / host,
           "top_kernels": dict(list(by_kernel.items())[:10])}
    emit(phase, part=name, arch=cfg.name, smi=smi, **extra, **row)
    return row


def gemm_timing(phase, cfg, gemms, rows_of, weights_of, cgen, peak_flops,
                peak_bw, smi, reps: int = 20) -> dict:
    """The fused GEMMs `gemms` over the parameters' own weights, fp32 with
    their epilogues: each on an x of `rows_of(g)` rows drawn from `cgen`
    (None: skipped), every (w, shift) of `weights_of(g)` launched in turn
    within one CUDA graph: kernel, plain, torch.matmul and bound ms,
    summed as the kernels line's row-1 entry of the config."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms",
            "bytes_ms")
    total = dict.fromkeys(keys, 0.0)
    per = {}
    for g in gemms:
        m = rows_of(g)
        if m is None:
            continue
        k, n, act = g["k"], g["n"], g["act"]
        ws = weights_of(g)
        x = torch.randn(m, k, generator=cgen, device=cgen.device)
        plan = ops.default_tiles(m, k, n)
        count = len(ws)
        flops = 2.0 * m * k * n * count
        nbytes = 4.0 * (m * k + k * n + m * n
                        + (n if g["shift"] else 0)) * count
        row = {"ms": graph_ms(lambda: [gemm.gemm_fused_fwd(
                   x, w, None, sh, act=act, plan=plan) for w, sh in ws],
                   reps=reps),
               "plain_ms": graph_ms(lambda: [gemm.gemm_fused_plain(
                   x, w, None, sh, act=act) for w, sh in ws], reps=reps),
               "library_ms": graph_ms(lambda: [torch.matmul(x, w)
                                               for w, _ in ws], reps=reps),
               "ops_ms": flops / peak_flops * 1e3,
               "bytes_ms": nbytes / peak_bw * 1e3}
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        per[g["name"]] = {**row, "shape": [m, k, n], "act": act,
                          "shift": g["shift"], "launches": count,
                          "plan": list(plan)}
        for key in keys:
            total[key] += row[key]
        del x, ws
    total["bound_by"] = ("operations" if total["ops_ms"] >= total["bytes_ms"]
                         else "bytes")
    emit(phase, part="gemm", arch=cfg.name, smi=smi, gemms=per, **total)
    return total


def frontend_gemm_timing(cfg, params, rows, cgen, peak_flops, peak_bw,
                         smi) -> dict:
    """The projector GEMMs and the head at the rows the phases give them
    (`rows`), one launch each, through `gemm_timing`."""
    fe = params["frontend"]

    def weights_of(g):
        if g["rows"] == "head":
            return [(tfm.head_weight(params, cfg), None)]
        return [(fe[g["param"]],
                 fe["b" + g["param"][1:]] if g["shift"] else None)]

    return gemm_timing("timing_frontends", cfg, frontend_gemms(cfg),
                       lambda g: rows.get(g["rows"]), weights_of, cgen,
                       peak_flops, peak_bw, smi)


def timing_vlm_phase(cfg, params, dev, cgen, peak_flops, peak_bw,
                     smi) -> dict:
    """Phase timing_frontends for internvl2-2b: the prefill of vlm and a
    decode step against its 336-row caches (host ms, device ms by kernel,
    busy share); the flash forward at the prefill's attention (causal, 16 /
    8 heads of 128) and the decode kernel at a decode step (G = 2), each
    kernel, plain, bound and SDPA ms; the projector GEMMs and the head."""
    b, text = VLM_PREFILL
    s = cfg.frontend_tokens + text
    gen = torch.Generator(device=dev).manual_seed(31)
    inputs = input_tensors(cfg, ShapeConfig("vlm", s, b, "prefill"),
                           generator=gen, device=dev)
    cuda = make_engine("cuda")
    prefill, decode = make_prefill_step(cuda, cfg), make_decode_step(cuda,
                                                                     cfg)
    caches = kvcache.cache_init(cfg, b, s + VLM_DECODE_STEPS, device=dev)
    tok = torch.ones((b, 1), dtype=torch.int64, device=dev)
    pos = torch.tensor(s, device=dev)
    with torch.inference_mode():
        steps = {"prefill": step_breakdown(
                     "prefill", lambda: prefill(params, inputs), smi, cfg,
                     batch=b, positions=s),
                 "decode": step_breakdown(
                     "decode_step", lambda: decode(params, caches, tok, pos),
                     smi, cfg, batch=b, cache_rows=s + VLM_DECODE_STEPS)}
    del caches
    attn = attn_timing_rows(cfg, {
        "vlm_prefill": (b, s, s, None, True),
        "vlm_decode": (b, 1, s + VLM_DECODE_STEPS, [s + 1] * b, False)},
        cgen, peak_flops, peak_bw, smi, "timing_frontends")
    gem = frontend_gemm_timing(cfg, params, {"frontend": b
                                             * cfg.frontend_tokens,
                                             "head": b}, cgen, peak_flops,
                               peak_bw, smi)
    return {"steps": steps, "attention": attn, "gemm": gem}


def timing_audio_phase(cfg, params, dev, cgen, peak_flops, peak_bw,
                       smi) -> dict:
    """Phase timing_frontends for hubert-xlarge: the forward of audio (host
    ms, device ms by kernel, busy share); the flash forward at its
    attention (head dim 80, not causal), kernel under each plan, plain,
    bound and SDPA ms; the projection GEMM and the head."""
    b, s = AUDIO_FRAMES
    gen = torch.Generator(device=dev).manual_seed(41)
    inputs = input_tensors(cfg, ShapeConfig("audio", s, b, "prefill"),
                           generator=gen, device=dev)
    forward = make_forward_step(make_engine("cuda"), cfg)
    with torch.inference_mode():
        steps = {"forward": step_breakdown(
            "forward", lambda: forward(params, inputs), smi, cfg,
            frames=[b, s])}
    attn = attn_timing_rows(cfg, {"audio_forward": (b, s, s, None, False)},
                            cgen, peak_flops, peak_bw, smi,
                            "timing_frontends")
    gem = frontend_gemm_timing(cfg, params, {"frontend": b * s, "head": b},
                               cgen, peak_flops, peak_bw, smi)
    return {"steps": steps, "attention": attn, "gemm": gem}


# ------------------------------------------------------------ the hybrid ---

def hybrid_gemms(cfg) -> list[dict]:
    """The GEMMs one dispatch of the hybrid runs, as `lm_gemms`: each
    mamba layer's six projections (`ssm_gemms`), each super entry's shared
    block (win over concat(h, embedding), q, k, v, o, the gelu MLP's up
    and down, wout) and the tied head; `rows` names the rows each runs on
    ("layer" or "head"), `param` where its weight lives."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    n_super = tfm.stack_program(cfg)[0][1]
    out = [{**g, "rows": "layer", "param": ("mixer", g["name"])}
           for g in ssm_gemms(cfg) if g["name"] != "head"]
    for name, k, n, act, path in (
            ("win", 2 * d, d, "linear", ("win",)),
            ("q", d, q, "linear", ("attn", "wq")),
            ("k", d, kv, "linear", ("attn", "wk")),
            ("v", d, kv, "linear", ("attn", "wv")),
            ("o", q, d, "linear", ("attn", "wo")),
            ("up", d, f, cfg.act, ("mlp", "wu")),
            ("down", f, d, "linear", ("mlp", "wd")),
            ("wout", d, d, "linear", ("wout",))):
        out.append({"name": name, "k": k, "n": n, "act": act,
                    "shift": False, "per_dispatch": n_super,
                    "trans": False, "rows": "layer",
                    "param": ("shared", *path)})
    return out + [{"name": "head", "k": d, "n": cfg.vocab_padded,
                   "act": "linear", "shift": False, "per_dispatch": 1,
                   "trans": cfg.tie_embeddings, "rows": "head",
                   "param": ("head",)}]


def hybrid_call_launches(cfg, layer_rows: int, head_rows, kind: str) -> dict:
    """The kernel launches of one hybrid call: a prefill (`kind`
    "prefill": a flash forward a super entry, an SSD scan a mamba layer)
    or a decode step ("decode": a split-KV launch a super entry), its
    GEMMs (`hybrid_gemms`) on `layer_rows` rows and the head on
    `head_rows` (None: no head, as the slot engine's prefill) with the
    forward launches by regime."""
    want = dict.fromkeys(all_launches(), 0)
    for g in hybrid_gemms(cfg):
        m = layer_rows if g["rows"] == "layer" else head_rows
        if m is None:
            continue
        plan = ops.default_tiles(m, g["k"], g["n"])
        want["gemm_fused_fwd"] += g["per_dispatch"]
        want[f"gemm_fwd_regime_{plan.regime.lower()}"] += g["per_dispatch"]
    n_super = tfm.stack_program(cfg)[0][1]
    if kind == "prefill":
        want["flash_attention"] = n_super
        want["ssd_scan"] = cfg.n_layers
    else:
        want["flash_decode"] = n_super
    return want


def hybrid_params(cfg, dev):
    """Full-width, full-depth random parameters from a seed, drawn on the
    card: every mixer's dt bias, A and D moved off the init's constants
    (as `ssm_params`) and the shared block's norm scales off 1."""
    gen = torch.Generator(device=dev).manual_seed(51)
    params = tfm.init_params(cfg, generator=gen, device=dev)
    with torch.no_grad():
        for lp in params["layers"]:
            for name, scale in (("dt_bias", 0.5), ("A_log", 0.3),
                                ("D", 0.5)):
                t = lp["mixer"][name]
                t.add_(torch.randn(t.shape, generator=gen, device=dev)
                       * scale)
        for name in ("norm_in", "norm1", "norm2"):
            t = params["shared"][name]["scale"]
            t.add_(torch.randn(t.shape, generator=gen, device=dev) * 0.1)
    return params


def hybrid_weight(params, cfg, g, i=0):
    """The weight of GEMM `g` (`hybrid_gemms`) of mamba layer `i` (the
    shared block's and the head's have one)."""
    path = g["param"]
    if path[0] == "head":
        return tfm.head_weight(params, cfg)
    t = (params["layers"][i] if path[0] == "mixer" else params)
    for key in path:
        t = t[key]
    return t


def check_hybrid_phase(cfg, cgen) -> dict:
    """Phase check_hybrid: zamba2-7b's GEMMs (`hybrid_gemms`, each
    distinct (K, N)) at every row count its phases give them (the decode
    rows, the prefill's, the hybrid_serve step's slots and each
    hybrid_serve admission's prompt but its last token; the head at the
    decode rows and the slots), the SSD kernel at the prefill shape and
    at each hybrid_serve admission, the flash forward at the prefill's
    attention (32 / 32 heads of 112, causal) and at each hybrid_serve
    admission's, and the split-KV decode at a decode step (G = 1, 528
    rows) and at a hybrid_serve step, fp32 and bf16, each against its
    plain version as phases 2, 9-10 and 20.  Returns the fp32 max-abs
    errors by kernel."""
    b, s = HYBRID_PREFILL
    rows = s + HYBRID_DECODE_STEPS
    slots, cache = HYBRID_SERVE["slots"], HYBRID_SERVE["max_len"]
    admitted = sorted({len(r.prompt) - 1
                       for r in hybrid_serve_requests(cfg)})
    out = {"gemm": 0.0, "ssd": 0.0}
    gemms, seen = [], set()
    for g in hybrid_gemms(cfg):
        for m in ((b, b * s, slots, *admitted) if g["rows"] == "layer"
                  else (b, slots)):
            key = (m, g["k"], g["n"], g["trans"])
            if key in seen:
                continue
            seen.add(key)
            res = check_shape(m, g["k"], g["n"],
                              (ops.default_tiles(m, g["k"], g["n"]),), cgen,
                              trans=g["trans"])
            out["gemm"] = max(out["gemm"], res["max_abs_err_fp32"])
            gemms.append({"gemm": g["name"], **res})
    ssd_rows = []
    for case in [ssd_shape(cfg, b, s)] + [ssd_shape(cfg, 1, n)
                                          for n in admitted]:
        for dtype in (torch.float32, torch.bfloat16):
            for init in (False, True):
                err, mabs, _ = check_ssd_case(case, dtype, init, cgen)
                if dtype == torch.float32:
                    out["ssd"] = max(out["ssd"], mabs)
                ssd_rows.append({"case": list(case), "dtype": str(dtype),
                                 "init": init, "relmax": err})
    cases, worst = check_attn_cases(cfg, cgen, [
        ("attn", "hybrid_prefill", (b, s, s, None, True)),
        *(("attn", f"hybrid_serve_prefill_{n}", (1, n, n, None, True))
          for n in admitted),
        ("decode", "hybrid_decode", (b, 1, rows, [rows - 15, rows], False)),
        ("decode", "hybrid_serve_step", (
            slots, 1, cache, [cache, cache // 3, 1, 0][:slots], False))])
    out.update(worst)
    emit("check_hybrid", arch=cfg.name, gemms=gemms, ssd=ssd_rows,
         attention=cases, max_abs_err=out)
    return out


def hybrid_phase(cfg, params, dev) -> dict:
    """Phase hybrid: zamba2-7b at full width and depth, a prefill of
    HYBRID_PREFILL tokens (two SSD chunks a sequence) and
    HYBRID_DECODE_STEPS greedy decode steps against their 528-row caches
    (the shared block's decode on the split-KV kernel at head dim 112),
    through `prefill_decode_phase`, the tokens equal."""
    b, s = HYBRID_PREFILL
    rng = np.random.default_rng(52)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (b, s))).to(dev)
    return prefill_decode_phase(
        "hybrid", cfg, params, dev, {"tokens": tokens}, s,
        HYBRID_DECODE_STEPS, hybrid_call_launches(cfg, b * s, b, "prefill"),
        hybrid_call_launches(cfg, b, b, "decode"),
        strict_tokens=True, program=tfm.stack_program(cfg),
        ssd_heads=cfg.ssm_nheads, state=cfg.ssm_state, chunk=cfg.ssm_chunk,
        prompt=s)


def hybrid_serve_requests(cfg) -> list:
    """Phase hybrid_serve's requests, made anew from their seed."""
    return requests(cfg, HYBRID_SERVE["requests"], 53,
                    HYBRID_SERVE["prompt"], HYBRID_SERVE["new"])


def hybrid_serve_phase(cfg, params, dev) -> dict:
    """Phase hybrid_serve: the slot engine on `cuda` serves
    HYBRID_SERVE's requests through 4 slots, so slots are reused through
    the zeroing route, with the launch counts set to 0 just before and
    read just after: every prompt prefilled (an SSD launch a mamba layer,
    a flash forward a super entry), every decode step's shared block on
    the split-KV kernel, launches exact; each reused-slot request gives
    its stream alone; every stream is token for token the slot engine's
    on `eager` on the card."""
    cuda, eager = make_engine("cuda"), make_engine("eager", device=dev)
    n, slots = HYBRID_SERVE["requests"], HYBRID_SERVE["slots"]
    kw = dict(engine=cuda, slots=slots, max_len=HYBRID_SERVE["max_len"])
    server = ServingEngine(cfg, params, **kw)
    reqs = hybrid_serve_requests(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    server.run(reqs)  # ---- the hybrid's serving path, driven once
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    dispatch = backends.dispatch_counts()
    st = server.stats()
    want = dict.fromkeys(launches, 0)
    for r in reqs:  # each admission's prefill: all of a prompt but its last
        for k, v in hybrid_call_launches(cfg, len(r.prompt) - 1, None,
                                         "prefill").items():
            want[k] += v
    for k, v in hybrid_call_launches(cfg, slots, slots, "decode").items():
        want[k] += st["steps"] * v
    reused = reqs[slots:]
    alone = hybrid_serve_requests(cfg)[slots:]
    for r in alone:
        ServingEngine(cfg, params, **kw).run([r])
    same = [a.out == r.out for a, r in zip(alone, reused)]
    plain = hybrid_serve_requests(cfg)
    ServingEngine(cfg, params, **{**kw, "engine": eager}).run(plain)
    equal = [a.out == r.out for a, r in zip(plain, reqs)]
    emit("hybrid_serve", arch=cfg.name, slots=slots, requests=n,
         max_len=HYBRID_SERVE["max_len"],
         completed=st["requests"]["completed"], tokens=st["tokens"],
         prompt_tokens=sum(len(r.prompt) for r in reqs), steps=st["steps"],
         wall_s=wall, tokens_per_s=st["throughput"],
         p50_ms=st["latency_s"]["p50"] * 1e3,
         p99_ms=st["latency_s"]["p99"] * 1e3,
         peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         launches=launches, want_launches=want,
         engine_dispatch={f"{b}.{o}": c for (b, o), c in dispatch.items()},
         reused_slot_requests=len(reused), equal_to_alone=same,
         equal_to_eager=equal, streams=[r.out for r in reqs])
    check(st["requests"]["completed"] == n
          and all(r.done and len(r.out) == r.max_new for r in reqs),
          f"{st['requests']['completed']} of {n} completed")
    check(launches == want, f"hybrid_serve launches {launches}, want {want}")
    check(all(b == "cuda" for b, _ in dispatch),
          f"an engine op left the cuda backend: {dispatch}")
    check(all(same), f"a reused slot's stream differs from the request "
          f"alone: {same}")
    check(all(equal), f"cuda vs eager slot-engine streams differ: {equal}")
    return {"launches": launches, "stats": st, "wall_s": wall}


def hybrid_gemm_timing(cfg, params, cgen, peak_flops, peak_bw, smi) -> dict:
    """The GEMMs of one hybrid decode dispatch at batch HYBRID_PREFILL[0]
    through `gemm_timing`: each mamba projection over all 81 layers'
    weights, each shared-block GEMM 13 times over its one weight, the
    head once, each kind's launches of a dispatch in one CUDA graph."""
    def weights_of(g):
        if g["param"][0] == "mixer":
            return [(hybrid_weight(params, cfg, g, i), None)
                    for i in range(cfg.n_layers)]
        return [(hybrid_weight(params, cfg, g), None)] * g["per_dispatch"]

    return gemm_timing("timing_hybrid", cfg, hybrid_gemms(cfg),
                       lambda g: HYBRID_PREFILL[0], weights_of, cgen,
                       peak_flops, peak_bw, smi, reps=2)


def timing_hybrid_phase(cfg, params, dev, cgen, peak_flops, peak_bw,
                        smi) -> dict:
    """Phase timing_hybrid: the prefill of hybrid and a decode step
    against its 528-row caches (host ms, device ms by kernel, busy share);
    the flash forward at the prefill's attention (2 x 512, 32 / 32 heads
    of 112, causal) and the decode kernel at a decode step (G = 1, 528
    rows), each kernel, plain, bound and SDPA ms; the SSD kernel at the
    prefill shape (kernel, plain, bound; no library call); the GEMMs of a
    decode dispatch (`hybrid_gemm_timing`)."""
    b, s = HYBRID_PREFILL
    rows = s + HYBRID_DECODE_STEPS
    rng = np.random.default_rng(54)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (b, s))).to(dev)
    cuda = make_engine("cuda")
    prefill, decode = make_prefill_step(cuda, cfg), make_decode_step(cuda,
                                                                     cfg)
    caches = kvcache.cache_init(cfg, b, rows, device=dev)
    tok = tokens[:, -1:]
    pos = torch.tensor(s, device=dev)
    with torch.inference_mode():
        steps = {"prefill": step_breakdown(
                     "prefill", lambda: prefill(params, {"tokens": tokens}),
                     smi, cfg, phase="timing_hybrid", batch=b, positions=s),
                 "decode": step_breakdown(
                     "decode_step", lambda: decode(params, caches, tok, pos),
                     smi, cfg, phase="timing_hybrid", batch=b,
                     cache_rows=rows)}
    del caches
    attn = attn_timing_rows(cfg, {
        "hybrid_prefill": (b, s, s, None, True),
        "hybrid_decode": (b, 1, rows, [rows] * b, False)},
        cgen, peak_flops, peak_bw, smi, "timing_hybrid")
    case = ssd_shape(cfg, b, s)
    x, dt, a, bm, cm, _ = ssd_operands(*case[:6], torch.float32, cgen)
    da = (dt * a).contiguous()
    flops, nbytes = time_ssd.ssd_work(x, bm, case[6])
    bound_ms, bound_by = bound(flops, nbytes, peak_flops, peak_bw)
    ms = graph_ms(lambda: ops.ssd(x, dt, a, bm, cm, chunk=case[6]))
    ssd_row = {"ms": ms, "plain_ms": graph_ms(lambda: ssd.ssd_scan_plain(
                   x, dt, da, bm, cm, chunk=case[6])),
               "library_ms": None, "bound_ms": bound_ms,
               "bound_by": bound_by, "ops_ms": flops / peak_flops * 1e3,
               "bytes_ms": nbytes / peak_bw * 1e3,
               "bound_share": bound_ms / ms,
               "plan": list(ssd.plan_for(*case))}
    emit("timing_hybrid", part="ssd_scan", arch=cfg.name, smi=smi,
         shape=list(case), **ssd_row)
    del x, dt, a, bm, cm, da
    gem = hybrid_gemm_timing(cfg, params, cgen, peak_flops, peak_bw, smi)
    return {"steps": steps, "attention": attn, "ssd": ssd_row, "gemm": gem}


# ------------------------------------------------------------------ MLA ---

def mla_gemms(cfg) -> list[dict]:
    """The fused GEMMs of one call of the MLA stack, as `moe_gemms`: each
    layer's wq, w_dkv and wo (and w_uk / w_uv, which make the per-head K /
    V, in the prefill only: the absorbed decode runs them as einsums), the
    dense first layer's SwiGLU, each MoE layer's router (fp32 out) and
    shared gate / up / down, and the untied head; `layers` names the
    layers a GEMM runs in ("all", "dense", "moe")."""
    d, h, f = cfg.d_model, cfg.n_heads, cfg.n_shared_experts * cfg.moe_d_ff
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    lora, vd = cfg.kv_lora_rank, cfg.v_head_dim
    table = [
        ("wq", d, h * (nope + rope), "linear", ("attn", "wq"), "all", False),
        ("w_dkv", d, lora + rope, "linear", ("attn", "w_dkv"), "all", False),
        ("w_uk", lora, h * nope, "linear", ("attn", "w_uk"), "all", True),
        ("w_uv", lora, h * vd, "linear", ("attn", "w_uv"), "all", True),
        ("wo", h * vd, d, "linear", ("attn", "wo"), "all", False),
        ("gate", d, cfg.d_ff, "silu", ("mlp", "wg"), "dense", False),
        ("up", d, cfg.d_ff, "linear", ("mlp", "wu"), "dense", False),
        ("down", cfg.d_ff, d, "linear", ("mlp", "wd"), "dense", False),
        ("router", d, cfg.n_routed_experts, "linear", ("moe", "router"),
         "moe", False),
        ("shared_gate", d, f, "silu", ("moe", "shared", "wg"), "moe", False),
        ("shared_up", d, f, "linear", ("moe", "shared", "wu"), "moe", False),
        ("shared_down", f, d, "linear", ("moe", "shared", "wd"), "moe",
         False)]
    dense = cfg.first_dense_layers
    count = {"all": cfg.n_layers, "dense": dense,
             "moe": cfg.n_layers - dense}
    out = [{"name": name, "k": k, "n": n, "act": act, "leaf": leaf,
            "layers": layers, "per_dispatch": count[layers],
            "prefill_only": pre, "shift": False,
            "out_dtype": torch.float32 if name == "router" else None}
           for name, k, n, act, leaf, layers, pre in table]
    return out + [{"name": "head", "k": d, "n": cfg.vocab_padded,
                   "act": "linear", "leaf": ("lm_head", "w"),
                   "layers": None, "per_dispatch": 1, "prefill_only": False,
                   "shift": False, "out_dtype": None}]


def mla_weights(params, cfg, g) -> list[torch.Tensor]:
    """The weights of GEMM `g` of `mla_gemms` in one call, layer by
    layer."""
    if g["name"] == "head":
        return [tfm.head_weight(params, cfg)]
    dense = cfg.first_dense_layers
    layers = {"all": params["layers"], "dense": params["layers"][:dense],
              "moe": params["layers"][dense:]}[g["layers"]]
    out = []
    for tree in layers:
        for key in g["leaf"]:
            tree = tree[key]
        out.append(tree)
    return out


def absorbed_shapes(cfg, rows: int) -> list[tuple]:
    """The absorbed decode's two einsums of one layer on `rows` tokens as
    bmm launches (E, M, K, N), one matrix a head: q_nope @ W_uk, then the
    attention's latent output @ W_uv."""
    h, nope = cfg.n_heads, cfg.qk_nope_dim
    lora, vd = cfg.kv_lora_rank, cfg.v_head_dim
    return [(h, rows, nope, lora), (h, rows, lora, vd)]


def latent_cfg(cfg):
    """The absorbed decode's attention as heads: cfg's query heads over one
    latent kv-head of kv_lora_rank + qk_rope_dim (576)."""
    return dataclasses.replace(cfg, n_kv_heads=1,
                               head_dim=cfg.kv_lora_rank + cfg.qk_rope_dim)


def mla_call_launches(cfg, b: int, s: int, kind: str,
                      cache_rows: int = 0) -> dict:
    """The kernel launches of one MLA prefill (`kind` "prefill", b rows of
    s tokens; the head on one position a row) or decode step ("decode", b
    rows of a chunk of s tokens against `cache_rows` latent rows; the head
    on every position): the fused GEMMs of `mla_gemms`, per MoE layer the
    three expert bmm launches, per layer one flash forward (prefill) or
    the two absorbed einsums on the bmm kernel and one attention launch
    (decode: the split-KV kernel where the dispatch is decode-shaped,
    `ops.use_decode_formulation`, else the flash forward at 576); with the
    forward launches by regime."""
    want = dict.fromkeys(all_launches(), 0)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    plans = []
    for g in mla_gemms(cfg):
        if g["prefill_only"] and kind == "decode":
            continue
        m = b if g["name"] == "head" and kind == "prefill" else b * s
        want["gemm_fused_fwd"] += g["per_dispatch"]
        plans.append((ops.default_tiles(m, g["k"], g["n"]),
                      g["per_dispatch"]))
    bmms = [(shape, n_moe) for shape in
            expert_shapes(cfg, b * moe.capacity(s, cfg))]
    if kind == "decode":
        bmms += [(shape, cfg.n_layers) for shape in absorbed_shapes(cfg,
                                                                    b * s)]
        split = ops.use_decode_formulation(s, cache_rows)
        want["flash_decode" if split else "flash_attention"] = cfg.n_layers
    else:
        want["flash_attention"] = cfg.n_layers
    for (_, m, k, n), count in bmms:
        want["bmm_fwd"] += count
        plans.append((ops.bmm_plan_for(m, k, n), count))
    for plan, count in plans:
        want[f"gemm_fwd_regime_{plan.regime.lower()}"] += count
    return want


def refused_at_mla_dims() -> dict:
    """At the latent's 576 the forward's 8-lane plans (their blocks do not
    fit in shared memory) and dQ / dK / dV (never trained), for
    `refused`."""
    q, k, _ = zero_operands(576, h=16, skv=300, kv=1)
    return {f"flash_attention_fwd plan {tuple(plan)} at 576": (
                lambda plan=plan: fa.flash_attention_fwd(q, k, k, plan=plan),
                576)
            for plan in fa.PLANS[:2]} | bwd_refusals(576)


def check_mla_phase(cfg, mgen) -> dict:
    """Phase check_mla: deepseek-v2-lite-16b's fused GEMMs (`mla_gemms`,
    each distinct (K, N)) at every row count the MLA phases give them (the
    decode rows, mla_serve's slots, the prefill's tokens; w_uk / w_uv at
    the prefill's only; the head at the decode rows and the slots), the
    expert bmm (64 experts) at the prefill's, the decode's and mla_serve's
    dispatch rows and the two absorbed einsums on the bmm kernel at the
    decode rows and the slots, each against its plain version; the flash
    forward at head dim 192 (16 / 16 heads: B 1-2, S 16-512, causal and
    not, a kv_len with a 0) and the split-KV decode at 576 (16 heads over
    one latent kv-head: Sq 1 / 4 / 8 against 256 / 1024 rows, up to 47
    splits, and the mla and mla_serve steps), fp32 and bf16, as phases
    9-10 (every forward plan bitwise the path plan's, the merge bitwise
    `combine`, the sentinels exact); the refusals at 576 and 192.  Draws
    from its own generator.  Returns the fp32 max-abs errors by kernel."""
    b, s = MLA_PREFILL
    rows = s + MLA_DECODE_STEPS
    slots, cache = MLA_SERVE["slots"], MLA_SERVE["max_len"]
    out = {"gemm": 0.0, "bmm": 0.0}
    gemms, seen = [], set()
    for g in mla_gemms(cfg):
        ms = ((b, slots) if g["name"] == "head" else
              (b * s,) if g["prefill_only"] else (b, slots, b * s))
        for m in ms:
            key = (m, g["k"], g["n"])
            if key in seen:
                continue
            seen.add(key)
            res = check_shape(m, g["k"], g["n"],
                              (ops.default_tiles(m, g["k"], g["n"]),), mgen)
            out["gemm"] = max(out["gemm"], res["max_abs_err_fp32"])
            gemms.append({"gemm": g["name"], **res})
    bmms = []
    for m in sorted({b * moe.capacity(1, cfg), slots * moe.capacity(1, cfg),
                     b * moe.capacity(s, cfg)}):
        for e, _, k, n in expert_shapes(cfg, m)[1:]:
            bmms.append({"kind": "expert", **check_bmm_fwd(e, m, k, n,
                                                           mgen)})
    for m in (b, slots):
        for e, _, k, n in absorbed_shapes(cfg, m):
            bmms.append({"kind": "absorbed", **check_bmm_fwd(e, m, k, n,
                                                             mgen)})
    out["bmm"] = max(r["max_abs_err_fp32"] for r in bmms)
    fwd, worst = check_attn_cases(cfg, mgen, [
        ("attn", "mla_prefill", (b, s, s, None, True)),
        ("attn", "b1_s16", (1, 16, 16, None, True)),
        ("attn", "kv_len_0", (2, 100, 130, [130, 0], True)),
        ("attn", "not_causal", (2, 64, 200, [150, 64], False))])
    out["attn"] = worst["attn"]
    dec, worst = check_attn_cases(latent_cfg(cfg), mgen, [
        *(("decode", f"sq{sq}_skv{skv}", (3, sq, skv,
                                         [skv, skv // 3, 0], sq > 1))
          for sq in (1, 4, 8) for skv in (256, 1024)),
        ("decode", "splits_47", (2, 2, 3000, [3000, 2900], True)),
        ("decode", "mla_decode", (b, 1, rows, [rows, rows - 15], False)),
        ("decode", "mla_serve_step", (slots, 1, cache,
                                      [cache, cache // 3, 1, 0][:slots],
                                      False))])
    out["decode"] = worst["decode"]
    # the paths of the forward at 576 (mla_short_serve, mla_chunk), on a
    # generator of their own: the forward at their shapes, and the chunk's
    # GEMMs and absorbed einsums at its 128 rows (its expert bmm rows are
    # the decode's)
    fgen = torch.Generator(device=mgen.device).manual_seed(MLA_FWD_SEED)
    fwd576, worst = check_attn_cases(latent_cfg(cfg), fgen, [
        ("attn", "mla_short_step", MLA_SHORT_STEP),
        ("attn", "chunk_against_128", (2, 64, 128, [128, 64], True)),
        ("attn", "mla_chunk", MLA_CHUNK_STEP)])
    out["attn_576"] = worst["attn"]
    m = MLA_CHUNK["batch"] * MLA_CHUNK["chunk"]
    chunk_gemms, seen = [], set()
    for g in mla_gemms(cfg):
        if g["prefill_only"] or (g["k"], g["n"]) in seen:
            continue
        seen.add((g["k"], g["n"]))
        chunk_gemms.append({"gemm": g["name"], **check_shape(
            m, g["k"], g["n"], (ops.default_tiles(m, g["k"], g["n"]),),
            fgen)})
    chunk_bmm = [{"kind": "absorbed", **check_bmm_fwd(e, m, k, n, fgen)}
                 for e, _, k, n in absorbed_shapes(cfg, m)]
    check(MLA_CHUNK["batch"] * moe.capacity(MLA_CHUNK["chunk"], cfg)
          == b * moe.capacity(1, cfg), "the chunk's expert rows are new")
    out["gemm_chunk"] = max(r["max_abs_err_fp32"] for r in chunk_gemms)
    out["bmm_chunk"] = max(r["max_abs_err_fp32"] for r in chunk_bmm)
    emit("check_mla", arch=cfg.name, gemms=gemms, bmm=bmms, attention=fwd,
         decode=dec, plans_at_192=[list(p) for p in fa.plans_at(192)],
         decode_smem_bytes={"fp32": fd.smem_bytes(576),
                            "bf16": fd.smem_bytes(576, torch.bfloat16)},
         attention_576=fwd576,
         plans_at_576=[list(p) for p in fa.plans_at(576)],
         fwd_smem_bytes_576={
             "fp32": fa.fwd_smem_bytes(576, fa.PLANS[2]),
             "bf16": fa.fwd_smem_bytes(576, fa.PLANS[2], torch.bfloat16)},
         chunk_rows=m, chunk_gemms=chunk_gemms, chunk_bmm=chunk_bmm,
         refused=refused(refused_at_mla_dims()), max_abs_err=out)
    return out


def mla_params(cfg, dev):
    """Full-width, full-depth random parameters from a seed, drawn on the
    card (62.8 GB in fp32), every norm's scale moved off 1 (the latent's
    rms norm among them)."""
    gen = torch.Generator(device=dev).manual_seed(62)
    params = tfm.init_params(cfg, generator=gen, device=dev)
    with torch.no_grad():
        for name, t in flatten(params).items():
            if name.endswith("scale"):
                t.add_(torch.randn(t.shape, generator=gen, device=dev) * 0.1)
    return params


def mla_phase(cfg, params, dev) -> dict:
    """Phase mla: deepseek-v2-lite-16b at full width and depth, a prefill
    of MLA_PREFILL tokens (the flash forward at head dim 192) and
    MLA_DECODE_STEPS greedy decode steps against their 528-row latent
    caches (the absorbed decode: the split-KV kernel at 576, the einsums
    on the bmm kernel), through `prefill_decode_phase`, routes first, the
    tokens equal."""
    b, s = MLA_PREFILL
    rng = np.random.default_rng(64)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (b, s))).to(dev)
    return prefill_decode_phase(
        "mla", cfg, params, dev, {"tokens": tokens}, s, MLA_DECODE_STEPS,
        mla_call_launches(cfg, b, s, "prefill"),
        mla_call_launches(cfg, b, 1, "decode", s + MLA_DECODE_STEPS),
        strict_tokens=True, routed=True, program=tfm.stack_program(cfg),
        latent=[cfg.kv_lora_rank, cfg.qk_rope_dim],
        experts=[cfg.n_routed_experts, cfg.top_k, cfg.n_shared_experts],
        capacity={"prefill": moe.capacity(s, cfg),
                  "decode": moe.capacity(1, cfg)}, prompt=s)


def mla_serve_requests(cfg) -> list:
    """Phase mla_serve's requests, made anew from their seed."""
    return requests(cfg, MLA_SERVE["requests"], 65, MLA_SERVE["prompt"],
                    MLA_SERVE["new"])


def mla_serve_phase(cfg, params, dev, abs_err, phase="mla_serve",
                    max_len=MLA_SERVE["max_len"]) -> dict:
    """Phase mla_serve: the slot engine on `cuda` serves MLA_SERVE's
    requests through 4 slots on the replay route (every prompt token a
    decode step: the split-KV kernel at 576 against the 256-row latent
    caches), with the launch counts set to 0 just before and read just
    after, launches exact; each reused-slot request gives its stream
    alone; every stream equals the slot engine's on `eager` on the card,
    or differs first where eager's top-2 logit margin is below
    MARGIN_FACTOR x phase mla's logits error (a near tie).  The `eager`
    engine runs `cuda`'s expert choices (`RouteReplay`); while the streams
    agree, each route eager's own routers chose otherwise must be a near
    tie, as in phase mla.  Phase mla_short_serve (`max_len` None) is the
    same with the engine's defaults, 4 slots of 128 rows: every step's
    attention the flash forward at (576, not causal), none split-KV."""
    cuda, eager = make_engine("cuda"), make_engine("eager", device=dev)
    n = MLA_SERVE["requests"]
    kw = ({"engine": cuda} if max_len is None else  # the engine's defaults
          {"engine": cuda, "slots": MLA_SERVE["slots"], "max_len": max_len})
    server = ServingEngine(cfg, params, **kw)
    slots, rows = server.slots, server.max_len
    check(slots == MLA_SERVE["slots"], f"{phase}: {slots} slots")
    reqs = mla_serve_requests(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    with RouteLog() as routes, AttnLog() as attn_calls:
        server.run(reqs)  # ---- the MLA serving path, driven once
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    dispatch = backends.dispatch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    st = server.stats()
    want = {k: st["steps"] * v for k, v in
            mla_call_launches(cfg, slots, 1, "decode", rows).items()}
    reused = reqs[slots:]
    alone = mla_serve_requests(cfg)[slots:]
    for r in alone:
        ServingEngine(cfg, params, **kw).run([r])
    same = [a.out == r.out for a, r in zip(alone, reused)]
    plain = mla_serve_requests(cfg)
    with RouteReplay(routes.calls) as replayed:
        ServingEngine(cfg, params, **{**kw, "engine": eager}).run(plain)
    check(len(replayed.calls) == len(routes.calls),
          f"eager routed {len(replayed.calls)} times, cuda "
          f"{len(routes.calls)}")
    flips, _, _ = route_flips(cfg, routes.calls, replayed.calls)
    prob_err = max(float((pc - pe).abs().max()) for (_, pc), (_, pe)
                   in zip(routes.calls, replayed.calls))
    head = tfm.head_weight(params, cfg)
    mismatches = []
    for a, e in zip(reqs, plain):
        if a.out == e.out:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a.out, e.out)) if x != y)
        with torch.inference_mode():
            h, _ = tfm.forward_hidden(eager, cfg, params, tokens=torch.tensor(
                [e.prompt + e.out[:j]], device=dev))
            top2 = torch.topk(h[0, -1] @ head, 2).values
        mismatches.append({"rid": a.rid, "token": j,
                           "eager_margin": float(top2[0] - top2[1]),
                           "allowed_below": MARGIN_FACTOR * abs_err})
    emit(phase, arch=cfg.name, slots=slots, requests=n, max_len=rows,
         completed=st["requests"]["completed"], tokens=st["tokens"],
         prompt_tokens=sum(len(r.prompt) for r in reqs), steps=st["steps"],
         wall_s=wall, tokens_per_s=st["throughput"],
         p50_ms=st["latency_s"]["p50"] * 1e3,
         p99_ms=st["latency_s"]["p99"] * 1e3, peak_gb=peak_gb,
         launches=launches, want_launches=want,
         attention_launches=sorted(set(attn_calls.calls)),
         engine_dispatch={f"{b}.{o}": c for (b, o), c in dispatch.items()},
         reused_slot_requests=len(reused), equal_to_alone=same,
         equal_to_eager=[a.out == e.out for a, e in zip(reqs, plain)],
         mismatches=mismatches, streams=[r.out for r in reqs],
         route_flips=flips, router_prob_max_abs_err=prob_err,
         flip_allowed_below=MARGIN_FACTOR * prob_err)
    check(mismatches or all(f["eager_margin"] < MARGIN_FACTOR * prob_err
                            for f in flips),
          f"{phase}: {len(flips)} route flips, some at a clear margin: "
          f"{flips[:20]}")
    check(st["requests"]["completed"] == n
          and all(r.done and len(r.out) == r.max_new for r in reqs),
          f"{st['requests']['completed']} of {n} completed")
    check(launches == want, f"{phase} launches {launches}, want {want}")
    check(attn_calls.calls == [(cfg.kv_lora_rank + cfg.qk_rope_dim, False)]
          * want["flash_attention"],
          f"{phase} attention launches {sorted(set(attn_calls.calls))}")
    check(all(b == "cuda" for b, _ in dispatch),
          f"an engine op left the cuda backend: {dispatch}")
    check(all(same), f"a reused slot's stream differs from the request "
          f"alone: {same}")
    check(all(m["eager_margin"] < m["allowed_below"] for m in mismatches),
          f"{phase} cuda vs eager token mismatch at a clear margin: "
          f"{mismatches}")
    return {"launches": launches, "stats": st, "wall_s": wall}


def mla_chunk_phase(cfg, params, dev) -> dict:
    """Phase mla_chunk: `make_decode_step` on `cuda` and on `eager` at
    MLA_CHUNK's batch on zeroed latent caches of its `cache_rows`, fed the
    same MLA_CHUNK["chunks"] chunks of 64 tokens at positions 0 and 64
    (past ops.DECODE_MAX_SQ: each layer's absorbed attention is the flash
    forward at 576, causal, `kv_len = pos + C`), the launch counts set to
    0 just before each chunk: launches exact and every forward at (576,
    causal), no split-KV launch, every op on `cuda`, `eager` launching
    none.  `eager` runs `cuda`'s expert choices (`RouteReplay`), each
    route its own routers chose otherwise a near tie; the logits over the
    real vocabulary and the caches within LOGIT_TOL of `eager`'s; the
    greedy tokens equal, or differing only where eager's top-2 margin is
    below MARGIN_FACTOR x the logits error (each position apart: the
    chunks are fed, not sampled)."""
    b, c, n = MLA_CHUNK["batch"], MLA_CHUNK["chunk"], MLA_CHUNK["chunks"]
    rows = MLA_CHUNK["cache_rows"]
    rng = np.random.default_rng(MLA_CHUNK["seed"])
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (b, c * n))).to(dev)
    want = mla_call_launches(cfg, b, c, "decode", rows)
    out = {}
    with torch.inference_mode():
        for label in ("cuda", "eager"):
            step = make_decode_step(make_engine(label, device=dev), cfg)
            buf = kvcache.cache_init(cfg, b, rows, device=dev)
            run = {"logits": [], "launches": [], "attn": [], "dispatch": [],
                   "host_ms": []}
            with (RouteLog() if label == "cuda"
                  else RouteReplay(out["cuda"]["routes"])) as rl:
                for i in range(n):
                    torch.cuda.synchronize()
                    reset_all_launches()
                    with AttnLog() as attn_calls:
                        t0 = time.perf_counter()
                        lg, buf = step(params, buf,
                                       tokens[:, i * c:(i + 1) * c],
                                       torch.tensor(i * c, device=dev))
                        torch.cuda.synchronize()
                        run["host_ms"].append(
                            (time.perf_counter() - t0) * 1e3)
                    run["launches"].append(all_launches())
                    run["dispatch"].append(backends.dispatch_counts())
                    run["attn"].append(attn_calls.calls)
                    run["logits"].append(lg[..., :cfg.vocab_size])
            out[label] = {**run, "logits": torch.stack(run["logits"]),
                          "buf": buf, "routes": rl.calls}
    cu, ea = out["cuda"], out["eager"]
    check(bool(torch.isfinite(cu["logits"]).all()),
          "non-finite mla_chunk logits")
    ties = route_ties(cfg, cu["routes"], ea["routes"])
    errs = {"logits": relmax(cu["logits"], ea["logits"]),
            **cache_relmax(cfg, cu["buf"], ea["buf"], c * n)}
    abs_err = float((cu["logits"] - ea["logits"]).abs().max())
    top2 = torch.topk(ea["logits"], 2).values
    margin = top2[..., 0] - top2[..., 1]
    differ = cu["logits"].argmax(-1) != ea["logits"].argmax(-1)
    mismatches = [{"chunk": i, "row": r, "position": j,
                   "eager_margin": float(margin[i, r, j]),
                   "allowed_below": MARGIN_FACTOR * abs_err}
                  for i, r, j in differ.nonzero().tolist()]
    emit("mla_chunk", arch=cfg.name, layers=cfg.n_layers, batch=b,
         chunk=c, chunks=n, cache_rows=rows, relmax=errs,
         logits_max_abs_err=abs_err,
         logits_max_abs=float(ea["logits"].abs().max()),
         tokens_equal=not mismatches, mismatches=mismatches,
         eager_min_top2_margin=float(margin.min()),
         launches=cu["launches"], want_launches=want,
         attention_launches=sorted({a for calls in cu["attn"]
                                    for a in calls}),
         host_ms=cu["host_ms"], eager_host_ms=ea["host_ms"], **ties)
    for key, err in errs.items():
        check(math.isfinite(err) and err <= LOGIT_TOL,
              f"mla_chunk {key} cuda vs eager {err:.3e} > {LOGIT_TOL:g}")
    check(all(m["eager_margin"] < m["allowed_below"] for m in mismatches),
          f"mla_chunk greedy tokens differ at a clear margin: {mismatches}")
    for i in range(n):
        check(cu["launches"][i] == want,
              f"mla_chunk chunk {i} launches {cu['launches'][i]}, want "
              f"{want}")
        check(cu["attn"][i] == [(cfg.kv_lora_rank + cfg.qk_rope_dim, True)]
              * cfg.n_layers,
              f"mla_chunk chunk {i} attention launches {cu['attn'][i]}")
        check(all(bk == "cuda" for bk, _ in cu["dispatch"][i]),
              f"mla_chunk dispatches {cu['dispatch'][i]}")
        check(sum(ea["launches"][i].values()) == 0 and not ea["attn"][i],
              "the eager engine launched a kernel of the port")
    return {"launches": {k: sum(run[k] for run in cu["launches"])
                         for k in want},
            "errs": errs, "abs_err": abs_err}


def timing_mla_576(cfg, dev, peak_flops, peak_bw, smi) -> dict:
    """The flash forward at 576 at the shapes its paths give it, a slot
    step of mla_short_serve (MLA_SHORT_STEP) and mla_chunk's second chunk
    (MLA_CHUNK_STEP): kernel, plain, bound and SDPA (boolean mask, TF32
    off) ms, emitted as timing_mla lines, on a generator of its own."""
    fgen = torch.Generator(device=dev).manual_seed(MLA_FWD_SEED + 1)
    return attn_timing_rows(latent_cfg(cfg), {
        "mla_short_step": MLA_SHORT_STEP, "mla_chunk": MLA_CHUNK_STEP},
        fgen, peak_flops, peak_bw, smi, "timing_mla")


def timing_mla_phase(cfg, params, dev, mgen, peak_flops, peak_bw,
                     smi) -> dict:
    """Phase timing_mla: the prefill of mla and a decode step against its
    528-row latent caches (host ms, device ms by kernel, busy share); the
    flash forward at the prefill's attention (2 x 512, 16 / 16 heads of
    192, causal) and the split-KV decode at a decode step (16 heads over
    the 576-wide latent, 528 rows), each kernel, plain, bound and SDPA
    ms; the GEMMs of a decode dispatch over the model's own weights (each
    kind's launches in one CUDA graph) against torch.matmul; one MoE
    layer's expert bmm at the decode's 16 dispatch rows against torch.bmm;
    the two absorbed einsums at the decode's rows: the whole einsum, the
    bmm kernel on y already in (E, K, N) order, y's permuted copy alone,
    plain and torch.bmm."""
    b, s = MLA_PREFILL
    rows = s + MLA_DECODE_STEPS
    rng = np.random.default_rng(66)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (b, s))).to(dev)
    cuda = make_engine("cuda")
    prefill, decode = make_prefill_step(cuda, cfg), make_decode_step(cuda,
                                                                     cfg)
    caches = kvcache.cache_init(cfg, b, rows, device=dev)
    tok = tokens[:, -1:]
    pos = torch.tensor(s, device=dev)
    with torch.inference_mode():
        steps = {"prefill": step_breakdown(
                     "prefill", lambda: prefill(params, {"tokens": tokens}),
                     smi, cfg, phase="timing_mla", batch=b, positions=s),
                 "decode": step_breakdown(
                     "decode_step", lambda: decode(params, caches, tok, pos),
                     smi, cfg, phase="timing_mla", batch=b,
                     cache_rows=rows)}
    del caches
    attn = attn_timing_rows(cfg, {"mla_prefill": (b, s, s, None, True)},
                            mgen, peak_flops, peak_bw, smi, "timing_mla")
    attn.update(attn_timing_rows(latent_cfg(cfg), {
        "mla_decode": (b, 1, rows, [rows] * b, False)}, mgen, peak_flops,
        peak_bw, smi, "timing_mla"))
    gem = gemm_timing(
        "timing_mla", cfg, [g for g in mla_gemms(cfg)
                            if not g["prefill_only"]], lambda g: b,
        lambda g: [(w, None) for w in mla_weights(params, cfg, g)], mgen,
        peak_flops, peak_bw, smi, reps=2)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms",
            "bytes_ms")
    lp = params["layers"][cfg.first_dense_layers]
    expert = dict.fromkeys(keys, 0.0)
    m = b * moe.capacity(1, cfg)
    for (e, _, k, n), w in zip(expert_shapes(cfg, m), (
            lp["moe"]["wg"], lp["moe"]["wu"], lp["moe"]["wd"])):
        x = torch.randn(e, m, k, generator=mgen, device=dev)
        flops, nbytes = 2.0 * e * m * k * n, 4.0 * (e * m * k + e * k * n
                                                    + e * m * n)
        one = {"ms": graph_ms(lambda: gemm.bmm_fwd(
                   x, w, plan=ops.bmm_plan_for(m, k, n)), reps=5),
               "plain_ms": graph_ms(lambda: gemm.bmm_fwd_plain(x, w),
                                    reps=5),
               "library_ms": graph_ms(lambda: torch.bmm(x, w), reps=5),
               "ops_ms": flops / peak_flops * 1e3,
               "bytes_ms": nbytes / peak_bw * 1e3}
        one["bound_ms"] = max(one["ops_ms"], one["bytes_ms"])
        for key in keys:
            expert[key] += one[key]
        del x
    expert["bound_by"] = ("operations" if expert["ops_ms"]
                          >= expert["bytes_ms"] else "bytes")
    emit("timing_mla", part="expert_bmm", smi=smi, dispatch_rows=m,
         shapes=[list(t) for t in expert_shapes(cfg, m)], **expert,
         bound_share=expert["bound_ms"] / expert["ms"])
    h, nope = cfg.n_heads, cfg.qk_nope_dim
    lora, vd = cfg.kv_lora_rank, cfg.v_head_dim
    absorbed = {}
    for spec, w, width in (
            ("bqhn,rhn->bqhr", lp["attn"]["w_uk"].reshape(lora, h, nope),
             nope),
            ("bqhr,rhv->bqhv", lp["attn"]["w_uv"].reshape(lora, h, vd),
             lora)):
        x = torch.randn(b, 1, h, width, generator=mgen, device=dev)
        xs, ys, _, order, yorder = backends.bmm_spec(spec)
        xp = x.permute(*[xs.index(c) for c in order]).reshape(
            h, b, width).contiguous()
        yp = w.permute(*[ys.index(c) for c in yorder]).contiguous()
        e, k, n = yp.shape
        flops, nbytes = 2.0 * e * b * k * n, 4.0 * (e * b * k + e * k * n
                                                    + e * b * n)
        row = {"ms": graph_ms(lambda: backends.einsum_as_bmm(
                   spec, x, w, acc_dtype=torch.float32,
                   out_dtype=torch.float32)),
               "kernel_ms": graph_ms(lambda: gemm.bmm_fwd(xp, yp)),
               "permute_ms": graph_ms(lambda: w.permute(
                   *[ys.index(c) for c in yorder]).contiguous()),
               "plain_ms": graph_ms(lambda: gemm.bmm_fwd_plain(xp, yp)),
               "library_ms": graph_ms(lambda: torch.bmm(xp, yp)),
               "ops_ms": flops / peak_flops * 1e3,
               "bytes_ms": nbytes / peak_bw * 1e3, "bmm": [e, b, k, n]}
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        absorbed[spec] = row
        emit("timing_mla", part="absorbed_einsum", spec=spec, smi=smi,
             **row)
        del x, xp, yp
    return {"steps": steps, "attention": attn, "gemm": gem,
            "expert": expert, "absorbed": absorbed}


# ------------------------- training the SSM, audio and hybrid families ---

def attn_bwd_dims_phase(dev) -> dict:
    """Phase check_attn_bwd at head dims 80, 112 and 192 (each drawn from a
    generator of its own, TRAIN_SEED + the head dim): the lse forward, dQ
    and dK / dV against their plain versions as `check_attn_bwd_case` over
    the grid of phase 16 (HEAD_RATIOS, BWD_SHAPES, causal on and off,
    kv_len with a 0, fp32 and bf16) and at the model's training shape
    (hubert-xlarge's 4 x 500, 16 / 16 heads, not causal; zamba2-7b's 2 x
    512, 32 / 32 heads, causal; deepseek-v2-lite-16b's 2 x 512, 16 / 16
    heads of 192, causal); then dQ, dK / dV and `FlashAttention` refused
    at the latent's 576 with no launch.  Returns per head dim the fp32
    max-abs errors at the model's shape by output."""
    out = {}
    for d, (arch, (b, s), causal) in TRAIN_ATTN.items():
        gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED + d)
        worst = {"fp32": 0.0, "bf16": 0.0}
        cases = 0
        for h, kv in HEAD_RATIOS:
            for dt in (torch.float32, torch.bfloat16):
                kind = "fp32" if dt == torch.float32 else "bf16"
                for sq, skv in BWD_SHAPES:
                    q, k, v = qkv(2, sq, skv, h, kv, d, dt, gen)
                    kvl = torch.tensor([skv // 2 + 3, 0], dtype=torch.int32,
                                       device=dev)
                    for cz in (True, False):
                        for lens in (None, kvl):
                            errs, _ = check_attn_bwd_case(q, k, v, lens, cz,
                                                          gen)
                            worst[kind] = max(worst[kind],
                                              max(errs.values()))
                            cases += 1
        torch.cuda.synchronize()
        emit("check_attn_bwd", head_dim=d, grid_cases=cases, relmax=worst,
             plans_bitwise=[list(p) for p in fa.bwd_plans_at(d)])
        cfg = get_arch(arch)
        h = cfg.n_heads
        rows = []
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(b, s, s, h, cfg.n_kv_heads, d, dt, gen)
            errs, mabs = check_attn_bwd_case(q, k, v, None, causal, gen)
            if dt == torch.float32:
                out[d] = mabs
            rows.append({"dtype": str(dt), "relmax": errs, "max_abs": mabs})
            del q, k, v
        torch.cuda.synchronize()
        emit("check_attn_bwd", arch=arch, head_dim=d,
             shape=[b, s, s, h, cfg.n_kv_heads, d], causal=causal,
             cases=rows, bitwise_two_runs=True,
             path_plan=list(fa.bwd_plan_for(b, s, h, cfg.n_kv_heads, d)),
             plans_bitwise=[list(p) for p in fa.bwd_plans_at(d)])
    emit("check_attn_bwd", refused_at_576=refused(bwd_refusals(576)))
    return out


def train_gemms(cfg, b: int, s: int) -> list[dict]:
    """The GEMMs of one train step of a dense, SSM, audio, hybrid or MoE
    config (`lm_gemms`, `ssm_gemms`, `frontend_gemms`, `hybrid_gemms`,
    `moe_gemms`, `mla_gemms`: the MLA prefill's w_uk / w_uv run in
    training), each with `m`, its
    rows (batch x seq, the head's a CE chunk's: batch x min(512, seq)),
    `reps` a step (the head's once a chunk) and `remat` whether the
    backward recomputes it (all but the audio projection, which embeds
    the frames before the first layer)."""
    chunk = min(512, s)
    family = "mla" if cfg.is_mla else cfg.family
    gemms = {"dense": lm_gemms, "ssm": ssm_gemms, "audio": frontend_gemms,
             "hybrid": hybrid_gemms, "moe": moe_gemms,
             "mla": mla_gemms}[family](cfg)
    out = []
    for g in gemms:
        head = g["name"] == "head"
        out.append({**g, "m": b * (chunk if head else s),
                    "reps": g["per_dispatch"] * (s // chunk if head else 1),
                    "remat": g["name"] != "projection",
                    "trans": g.get("trans", False)})
    return out


def train_bmms(cfg, b: int, s: int) -> list[tuple]:
    """The expert bmm launches of one MoE layer in a train step at b x s
    (`expert_shapes` at b x capacity rows), (E, M, K, N) each; none for a
    stack without MoE layers."""
    if not n_moe_layers(cfg):
        return []
    return expert_shapes(cfg, b * moe.capacity(s, cfg))


def family_train_launches(cfg, b: int, s: int) -> dict:
    """Exact kernel launches of one train step (`loss_fn` and its gradient,
    remat) of a dense, SSM, audio, hybrid or MoE config at b x s: each
    GEMM's residual forward twice where the backward recomputes it, else
    once, by regime, one dX and one dW a call and the reduce passes their
    splits need; per MoE layer each of its three expert bmm the same way
    (forward and recompute by regime, `bmm_bwd_dx`, `bmm_bwd_dw` and their
    reduce passes); per attention layer two lse forwards, one dQ and one
    dK / dV; per mamba layer two einsum-form SSD dispatches (the forward
    and its recompute) and no SSD kernel launch."""
    want = dict.fromkeys(all_launches(), 0)
    for g in train_gemms(cfg, b, s):
        m, k, n, reps = g["m"], g["k"], g["n"], g["reps"]
        fwd = reps * (2 if g["remat"] else 1)
        dx = ops.default_bwd_tiles("dx", m, n, k)
        dw = (ops.default_bwd_tiles("dw", n, m, k) if g["trans"]
              else ops.default_bwd_tiles("dw", k, m, n))
        want["gemm_fused_fwd_res"] += fwd
        want[f"gemm_fwd_regime_"
             f"{ops.default_tiles(m, k, n).regime.lower()}"] += fwd
        want["gemm_bwd_dx"] += reps
        want["gemm_bwd_dw"] += reps
        want["gemm_bwd_reduce"] += reps * ((dx[3] > 1) + (dw[3] > 1))
    n_moe = n_moe_layers(cfg)
    for e, m, k, n in train_bmms(cfg, b, s):
        dx = ops.default_bwd_tiles("dx", m, n, k, e)
        dw = ops.default_bwd_tiles("dw", k, m, n, e)
        want["bmm_fwd"] += 2 * n_moe
        want[f"gemm_fwd_regime_"
             f"{ops.bmm_plan_for(m, k, n).regime.lower()}"] += 2 * n_moe
        want["bmm_bwd_dx"] += n_moe
        want["bmm_bwd_dw"] += n_moe
        want["gemm_bwd_reduce"] += n_moe * ((dx[3] > 1) + (dw[3] > 1))
    n_attn = {"dense": cfg.n_layers, "ssm": 0, "audio": cfg.n_layers,
              "hybrid": tfm.stack_program(cfg)[0][1],
              "moe": cfg.n_layers}[cfg.family]
    want["flash_attention_lse"] = 2 * n_attn
    want["flash_attention_bwd_dq"] = want["flash_attention_bwd_dkv"] = n_attn
    want["ssd_einsum_form"] = 2 * n_mamba(cfg)
    return want


def n_mamba(cfg) -> int:
    """Mamba layers of a config (all its layers for ssm and hybrid)."""
    return cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0


def check_train_gemms(phase, cfg, b: int, s: int, gen) -> dict:
    """dX and dW against their plain versions (`check_bwd_shape`, the
    path's plan and split, fp32 and bf16; the fp32 bar of a contraction
    past 4096 terms `gemm_tol`'s, as the LM head's: mamba2's tied head
    contracts 50288 in dX) and every backward plan bitwise
    the path plan's (`check_bwd_bits`) at each distinct shape of the
    config's train step (`train_gemms`); for a MoE config also the expert
    bmm at each distinct shape of `train_bmms` (`check_bmm_case` at the
    path's forward plan and the dX and dW plans and splits: each kernel
    against its plain version, every batch slice the 2-D kernel's, every
    backward plan bitwise).  Returns the fp32 max-abs errors by
    kernel."""
    worst = {"gemm_bwd_dx": 0.0, "gemm_bwd_dw": 0.0}
    seen = set()
    for g in train_gemms(cfg, b, s):
        shape = (g["m"], g["k"], g["n"])
        if shape in seen:
            continue
        seen.add(shape)
        res = check_bwd_shape(*shape, *bwd_plans(*shape), gen, long_k=True)
        for key in ("gemm_bwd_dx", "gemm_bwd_dw"):
            worst[key] = max(worst[key], res["max_abs_err_fp32"][key])
        bits = check_bwd_bits(*shape, gen)
        emit("check_bwd", path=phase, gemm=g["name"], **res,
             plans=bits["plans"], bitwise_cases=bits["bitwise_cases"])
    for shape in dict.fromkeys(train_bmms(cfg, b, s)):
        plan, dx_plan, dw_plan = bmm_plans(*shape)
        res = check_bmm_case(*shape, [(plan, *dx_plan), (plan, *dw_plan)],
                             gen)
        for key in ("bmm_bwd_dx", "bmm_bwd_dw"):
            worst[key] = max(worst.get(key, 0.0),
                             res["max_abs_err_fp32"][key])
        emit("check_bmm", path=phase, **res)
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return worst


def audio_batch(cfg, dev, run: dict, step: int) -> dict:
    """Train step `step`'s frames (standard normal) and labels for an
    audio config, drawn on the card from a generator seeded with run's
    seed and the step (`configs.base.input_tensors`).  `SyntheticLM`'s
    frames, as the JAX pipeline's, hold one value in all of a frame's
    features: the layer norm in front of the projection makes them exact
    zeros on the card, the whole forward with them, and the gradient
    through 48 layer norms at zero (each a gain of 1 / sqrt(eps), 316)
    overflows on every engine."""
    gen = torch.Generator(device=dev).manual_seed(1000 * run["seed"] + step)
    return input_tensors(cfg, ShapeConfig("train", run["seq"], run["batch"],
                                          "train"), generator=gen,
                         device=dev)


def prefill_launches(cfg) -> dict:
    """The launches a `no_grad` prefill of a trained `cfg` (no head) must
    show: per mamba layer one SSD launch and no einsum-form dispatch; per
    layer of a MoE stack one flash forward and per MoE layer its three
    expert bmm."""
    want = {}
    if n_mamba(cfg):
        want.update(ssd_scan=n_mamba(cfg), ssd_einsum_form=0)
    if n_moe_layers(cfg):
        want.update(flash_attention=cfg.n_layers,
                    bmm_fwd=3 * n_moe_layers(cfg))
    return want


def family_train_phase(phase, cfg, dev, run: dict, gen, data=None,
                       floor_step=None) -> dict:
    """Phases ssm_train, audio_train, hybrid_train, mla_train and moe_train
    (see the module docstring): the config's training GEMMs (and expert
    bmm) checked, then the step-1 loss and gradients of `loss_fn` on
    `cuda` (twice, bitwise) against `eager` and `ref`, then run["steps"]
    AdamW steps on `cuda`, `eager` and `ref` in that order (the counts set
    to 0 just before each) through `train_loop` or, given `data` (step ->
    batch), through `make_train_step` with train_loop's initial parameters
    and optimizer settings, `eager`'s kept as the reference and each other
    run's state freed after its drift is taken (the `ref` run, on `data`,
    with `make_train_step`'s arguments `floor_step` where `ref` would
    compute `eager`'s bits: two microbatches, or another CE chunk, the
    same function summed in another order), then a `no_grad` prefill of
    the model `cuda` trained (for a stack with mamba or MoE layers).
    Step-1 gradients are held to TRAIN_TOL or FLOOR_FACTOR x the same
    tensor's `ref`-`eager` gap, whichever is larger: at mamba2's 48 layers
    two correct fp32 programs part by more than TRAIN_TOL on a few small
    tensors (conv biases, A_log, dt_bias, sums over all 4096 positions).
    The parameters' drift is also taken apart (`sharp_params_farthest`:
    per tensor cuda and `ref` against `eager` over the elements whose
    step-1 gradient clears FLOOR_FACTOR x the tensor's cuda-eager error on
    both engines, cuda over the others, and their count), and held over
    the former, where run["sharp_tol"] is given, to it or FLOOR_FACTOR x
    `ref`'s, whichever is larger.  A MoE stack's runs
    record their routes by layer (`routing`): `cuda` its own, which
    `eager` and `ref` then run (`RouteReplay`), each route they would have
    chosen otherwise a near tie (`route_ties`); the prefill replays
    `cuda`'s routes per call.  run["steps"] 0 stops after step 1, whose
    peak memory is then held to run["peak_gb_bound"].  Returns the `cuda`
    run's launch counts (step 1's with no trajectory), step 1's and the
    GEMM checks' errors."""
    seed, b, s, steps = run["seed"], run["batch"], run["seq"], run["steps"]
    gemm_abs = check_train_gemms(phase, cfg, b, s, gen)
    engines = {"cuda": make_engine("cuda"),
               "eager": make_engine("eager", device=dev),
               "floor": make_engine(FLOOR_BACKEND, device=dev)}
    want = family_train_launches(cfg, b, s)
    routed = bool(n_moe_layers(cfg))
    params = lm_train_params(cfg, dev, seed)
    n_leaves = len(flatten(params))
    batch0 = (lm_train_batch(cfg, dev, 0, b, s, seed) if data is None
              else data(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_launches()
    with routing(cfg) as rc:
        loss_c, grads_c = lm_grads(engines["cuda"], cfg, params, batch0)
    torch.cuda.synchronize()
    step_launches = all_launches()
    step_dispatch = backends.dispatch_counts()
    routes = rc.calls if routed else None
    with routing(cfg) as rc2:
        loss_c2, grads_c2 = lm_grads(engines["cuda"], cfg, params, batch0)
    bitwise = torch.equal(loss_c, loss_c2) and all(
        torch.equal(g, grads_c2[k]) for k, g in grads_c.items())
    if routed:
        bitwise = bitwise and len(rc2.calls) == len(routes) and all(
            torch.equal(a[0], c[0]) for a, c in zip(routes, rc2.calls))
    del grads_c2
    with routing(cfg, routes) as re_:
        loss_e, grads_e = lm_grads(engines["eager"], cfg, params, batch0)
    grad_err = {k: relmax(g, grads_e[k]) for k, g in grads_c.items()}
    grad_abs_of = {k: pieces_max(g, grads_e[k], None)[0]
                   for k, g in grads_c.items()}
    grad_abs = max(float(e) for e in grad_abs_of.values())
    # The elements whose step-1 gradient clears FLOOR_FACTOR x its tensor's
    # cuda-eager error on both engines, so that AdamW steps them the same
    # way; an element nearer 0 may take opposite +-lr steps
    sharp = {k: torch.minimum(g.abs(), grads_e[k].abs())
             > FLOOR_FACTOR * grad_abs_of[k]
             for k, g in grads_c.items()} if steps else {}
    del grads_c
    with routing(cfg, routes):
        loss_f, grads_f = lm_grads(engines["floor"], cfg, params, batch0)
    grad_floor = {k: relmax(g, grads_e[k]) for k, g in grads_f.items()}
    torch.cuda.synchronize()
    step1_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del grads_f, grads_e, params
    torch.cuda.empty_cache()
    step1 = {"loss_rel_err": abs(loss_c.item() - loss_e.item())
             / abs(loss_e.item()),
             "loss_rel_floor": abs(loss_f.item() - loss_e.item())
             / abs(loss_e.item()),
             "peak_gb": step1_peak}
    if routed:
        step1["routes"] = {**route_ties(cfg, routes, re_.calls),
                           "recomputed": rc.recomputed}
    fields = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                  batch=b, seq=s, steps=steps, floor_backend=FLOOR_BACKEND,
                  reduced=run.get("reduced", []), step1=step1,
                  step1_grads_bitwise_two_runs=bitwise,
                  grad_relmax_worst=max(grad_err.values()),
                  grad_floor_worst=max(grad_floor.values()),
                  grad_max_abs_err=grad_abs,
                  grads_past_train_tol={k: [e, grad_floor[k]]
                                        for k, e in grad_err.items()
                                        if e > TRAIN_TOL},
                  floor_factor=FLOOR_FACTOR, step1_launches=step_launches,
                  want_step1_launches=want, floor_step=floor_step or {},
                  gemm_check_max_abs=gemm_abs)

    def train(label, replay=None) -> dict:
        metrics: list = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_launches()
        t0 = time.perf_counter()
        with routing(cfg, replay) as rl:
            if data is None:
                p, st = train_loop(cfg, steps=steps, batch=b, seq=s,
                                   ckpt_dir="", seed=seed,
                                   engine=engines[label],
                                   metrics_out=metrics, log_every=steps)
            else:
                p = lm_train_params(cfg, dev, seed)
                st = opt.adamw_init(flatten(p))
                kw = {"ce_chunk": min(512, s)}  # train_loop's
                if label == "floor":
                    kw.update(floor_step or {})
                step = make_train_step(engines[label], cfg, opt.AdamWConfig(
                    lr=3e-4, warmup_steps=min(100, steps // 10 + 1),
                    decay_steps=steps), **kw)
                for i in range(steps):
                    p, st, m = step(p, st, data(i))
                    metrics.append({"step": i, "loss": float(m["loss"])})
            torch.cuda.synchronize()
        return {"nested": p, "params": flatten(p), "state": st,
                "losses": [m["loss"] for m in metrics],
                "wall_s": time.perf_counter() - t0,
                "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "launches": all_launches(),
                "dispatch": backends.dispatch_counts(),
                "routes": rl.calls if routed else None}

    kept = ("nested", "losses", "wall_s", "peak_gb", "launches", "dispatch",
            "routes")
    if steps:  # cuda first: in a MoE stack eager and ref follow its routes
        cu = train("cuda")  # the main path
        ea = train("eager", cu["routes"])
        err = drift(cu, ea)
        sharp_err = {k: [relmax(cu["params"][k], p, sharp[k]),
                         relmax(cu["params"][k], p, ~sharp[k]),
                         int(sharp[k].numel() - sharp[k].sum())]
                     for k, p in ea["params"].items()}
        if routed:
            fields["train_routes"] = route_ties(cfg, cu["routes"],
                                                ea["routes"])
        cu = {k: cu[k] for k in kept}
        torch.cuda.empty_cache()
        fl = train("floor", cu["routes"])
        floor = drift(fl, ea)
        for k, p in ea["params"].items():
            sharp_err[k].insert(1, relmax(fl["params"][k], p, sharp[k]))
        fl = {k: fl[k] for k in kept if k != "nested"}
        del sharp
    ops_used = {("cuda", "matmul")} | ({("cuda", "ssd")} if n_mamba(cfg)
                                       else set()) | (
        {("cuda", "attention")} if want["flash_attention_lse"] else set()) | (
        {("cuda", "einsum")} if routed else set())
    if steps:
        worst = {key: max(err[key].values()) for key in ("params", "moments")}
        worst_floor = {key: max(floor[key].values())
                       for key in ("params", "moments")}
        want_total = {k: steps * v for k, v in want.items()}
        fields.update(
            losses_cuda=cu["losses"], losses_eager=ea["losses"],
            losses_floor=fl["losses"], loss_rel_err=err["loss"],
            loss_rel_floor=floor["loss"],
            param_relmax_worst=worst["params"],
            param_floor_worst=worst_floor["params"],
            params_farthest={k: [e, floor["params"][k]] for k, e in sorted(
                err["params"].items(), key=lambda kv: -kv[1])[:6]},
            sharp_param_relmax_worst=max(e[0] for e in sharp_err.values()),
            sharp_param_floor_worst=max(e[1] for e in sharp_err.values()),
            sharp_params_farthest=dict(sorted(
                sharp_err.items(), key=lambda kv: -kv[1][0])[:6]),
            near_zero_params_farthest=dict(sorted(
                sharp_err.items(), key=lambda kv: -kv[1][2])[:6]),
            moment_relmax_worst=worst["moments"],
            moment_floor_worst=worst_floor["moments"],
            data="train_loop" if data is None else "make_train_step",
            launches=cu["launches"], want_launches=want_total,
            peak_gb={"cuda": cu["peak_gb"], "eager": ea["peak_gb"],
                     "floor": fl["peak_gb"]},
            wall_s={"cuda": cu["wall_s"], "eager": ea["wall_s"],
                    "floor": fl["wall_s"]},
            dispatch={f"{bk}.{o}": c for (bk, o), c in cu["dispatch"].items()},
            eager_launches=sum(ea["launches"].values()))
        prefill = {}
        want_prefill = prefill_launches(cfg)
        if want_prefill:  # serving the trained model: the kernels again
            reset_all_launches()
            with torch.no_grad():
                with (RouteLog() if routed else
                      contextlib.nullcontext()) as pl:
                    h, _ = tfm.forward_prefill(
                        engines["cuda"], cfg, cu["nested"],
                        tokens=batch0["tokens"], collect_caches=False)
                torch.cuda.synchronize()
                prefill["launches"] = {k: all_launches()[k]
                                       for k in want_prefill}
                with (RouteReplay(pl.calls) if routed else
                      contextlib.nullcontext()) as pr:
                    he, _ = tfm.forward_prefill(
                        engines["eager"], cfg, cu["nested"],
                        tokens=batch0["tokens"], collect_caches=False)
            prefill["relmax"] = relmax(h, he)
            prefill["finite"] = bool(torch.isfinite(h).all())
            if routed:
                prefill["routes"] = route_ties(cfg, pl.calls, pr.calls)
            del h, he
        fields["prefill_after_training"] = prefill
    emit(phase, **fields, grad_relmax=grad_err)
    check(step1["loss_rel_err"] <= FP32_TOL,
          f"step-1 loss cuda vs eager {step1['loss_rel_err']:.3e}")
    check(bitwise, "two cuda runs of the step-1 gradients differ")
    check(len(grad_err) == n_leaves,
          f"{len(grad_err)} gradients, want {n_leaves}")
    over = {k: (e, grad_floor[k]) for k, e in grad_err.items()
            if not e <= max(TRAIN_TOL, FLOOR_FACTOR * grad_floor[k])}
    check(not over, f"step-1 gradients cuda vs eager (and {FLOOR_BACKEND} "
                    f"vs eager) past the bar: {over}")
    check(step_launches == want,
          f"{phase} step-1 launches {step_launches}, want {want}")
    check(set(step_dispatch) == ops_used,
          f"an engine op left the cuda backend at step 1: {step_dispatch}")
    if routed:
        check(rc.recomputed == len(routes) == n_moe_layers(cfg),
              f"{len(routes)} MoE layers routed, {rc.recomputed} recomputed")
    if "peak_gb_bound" in run:
        check(step1_peak <= run["peak_gb_bound"],
              f"{phase} step-1 peak {step1_peak:.1f} GB past the "
              f"{run['peak_gb_bound']} GB predicted")
    if not steps:
        return {"launches": step_launches, "step_launches": step_launches,
                "gemm_abs": gemm_abs, "grad_abs": grad_abs}
    check(all(math.isfinite(x) for x in cu["losses"]), "non-finite loss")
    check(err["loss"][0] <= FP32_TOL,
          f"train_loop step-1 loss cuda vs eager {err['loss'][0]:.3e}")
    for i, (e, f) in enumerate(zip(err["loss"], floor["loss"])):
        check(e <= max(FP32_TOL, FLOOR_FACTOR * f),
              f"step-{i + 1} loss cuda vs eager {e:.3e}, "
              f"{FLOOR_BACKEND} vs eager {f:.3e}")
    for key in ("params", "moments"):
        check(worst[key] <= max(TRAIN_TOL, FLOOR_FACTOR * worst_floor[key]),
              f"{key} after {steps} steps: cuda vs eager {worst[key]:.3e}, "
              f"{FLOOR_BACKEND} vs eager {worst_floor[key]:.3e}")
    if "sharp_tol" in run:
        over = {k: e[:2] for k, e in sharp_err.items()
                if not e[0] <= max(run["sharp_tol"], FLOOR_FACTOR * e[1])}
        check(not over, f"parameters after {steps} steps over the elements "
                        f"of a sharp step-1 gradient, cuda vs eager (and "
                        f"{FLOOR_BACKEND} vs eager) past the bar: {over}")
    check(cu["launches"] == want_total,
          f"{phase} launches {cu['launches']}, want {want_total}")
    check(set(cu["dispatch"]) == ops_used,
          f"an engine op left the cuda backend: {cu['dispatch']}")
    check(sum(ea["launches"].values()) + sum(fl["launches"].values()) == 0,
          "the eager or floor engine launched a kernel of the port")
    if prefill:
        check(prefill["launches"] == want_prefill,
              f"the prefill after training launched {prefill['launches']}")
        check(prefill["finite"] and prefill["relmax"] <= TRAIN_TOL,
              f"the trained model's prefill cuda vs eager "
              f"{prefill['relmax']:.3e}")
    return {"launches": cu["launches"], "step_launches": step_launches,
            "gemm_abs": gemm_abs, "grad_abs": grad_abs}


def timing_family_train_phase(phase, cfg, dev, run: dict, gen, peak_flops,
                              peak_bw, smi, launches: dict) -> dict:
    """Phase timing_<phase>: a train step's ms, tokens/s and peak GB on
    `cuda` and `eager` and each one's device time by kernel; for a config
    with attention, the lse forward, dQ and dK / dV at its training shape
    (`attn_train_rows`, drawn from `gen`) with their launches a step from
    `launches`, phase <phase>'s counts over run["steps"] steps; for a MoE
    config also the expert bmm's dX and dW (`train_bmm_rows`)."""
    b, s = run["batch"], run["seq"]
    steps, by_kernel = train_step_timing(
        cfg, dev, run, batch=audio_batch(cfg, dev, run, 0)
        if cfg.frontend == "audio" else None)
    device_ms = {k: sum(r["ms"] for r in v.values())
                 for k, v in by_kernel.items()}
    emit(f"timing_{phase}_step", smi=smi, arch=cfg.name, batch=b, seq=s,
         steps=steps, device_ms=device_ms,
         device_busy_share={k: device_ms[k] / steps[k]["ms"]
                            for k in device_ms},
         top_kernels={k: dict(list(v.items())[:12])
                      for k, v in by_kernel.items()})
    if not launches["flash_attention_lse"]:
        return {}
    shape = (b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.causal)
    rows = attn_train_rows(shape, gen, peak_flops, peak_bw)
    for name, row in rows.items():
        emit(f"timing_{phase}", kernel=name, smi=smi,
             launches_per_step=launches[name] // run["steps"],
             shape=list(shape[:5]), causal=cfg.causal, **row)
    if n_moe_layers(cfg):
        rows.update(train_bmm_rows(
            phase, cfg, run, gen, peak_flops, peak_bw, smi,
            {k: v // run["steps"] for k, v in launches.items()}))
    return rows


def clones(obj) -> list[torch.Tensor]:
    """Detached copies of every tensor of a nested dict / list / tuple, in
    `flatten`'s order."""
    return [t.detach().clone() for t in flatten(obj).values()
            if isinstance(t, torch.Tensor)]


def same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(a, b))


def cnn_serve_path(dev):
    """Phase autotune's DARKNET19 serving path: `run(policy)` serves
    AUTOTUNE_CNN's batch through a CNNServingEngine over
    compile_cache(buckets=(8,), autotune=policy) and returns the served
    rows and a timer of the batch-8 forward."""
    a = AUTOTUNE_CNN
    gen = torch.Generator().manual_seed(a["seed"])
    net = Network(DARKNET19_CFG, make_engine("cuda"), generator=gen)
    randomize_bn(net, gen)
    images = np.random.default_rng(a["seed"]).standard_normal(
        (a["batch"], *net.in_shape)).astype(np.float32)

    def run(policy):
        cache = net.compile_cache(buckets=(a["batch"],), autotune=policy)
        reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(images)]
        CNNServingEngine(cache).run(reqs)  # ---- the CNN serving path
        check(all(r.done for r in reqs), "autotune: a CNN request is open")
        out = [torch.from_numpy(np.asarray(r.result)) for r in reqs]
        cn, x = cache.get(a["batch"]), torch.from_numpy(images).to(dev)
        return out, lambda: cuda_ms(lambda: cn(x), reps=10, repeats=3)
    return run


def cnn_train_path(dev):
    """Phase autotune's DARKNET19 training path: `run(policy)` takes one
    make_cnn_train_step step at AUTOTUNE_CNN's batch from a seeded network
    and returns its loss, parameters and AdamW state, and a step timer."""
    a = AUTOTUNE_CNN
    rng = np.random.default_rng(a["seed"] + 1)
    images = torch.from_numpy(rng.standard_normal(
        (a["batch"], 224, 224, 3)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 1000, a["batch"])).to(dev)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1)

    def run(policy):
        gen = torch.Generator().manual_seed(a["seed"])
        net = Network(DARKNET19_CFG, make_engine("cuda"), generator=gen)
        randomize_bn(net, gen)
        step = make_cnn_train_step(net, ocfg)
        state = opt.adamw_init(dict(net.named_parameters()))
        with backends.autotune_policy(policy):
            state, metrics = step(state, (images, labels))  # ---- the path
        out = clones([metrics["loss"], dict(net.named_parameters()), state])
        return out, lambda: cuda_ms(lambda: step(state, (images, labels)),
                                    reps=1, repeats=3)
    return run


def lm_train_path(cfg, dev):
    """Phase autotune's qwen2-0.5b training path: `run(policy)` takes one
    make_train_step step at AUTOTUNE_LM's 2 x 512 from parameters of its
    own generator and returns the loss, parameters and AdamW state, and a
    step timer."""
    a = AUTOTUNE_LM
    batch = lm_train_batch(cfg, dev, 0, a["batch"], a["seq"], a["seed"])
    step = make_train_step(make_engine("cuda"), cfg,
                           opt.AdamWConfig(lr=3e-4, warmup_steps=1),
                           ce_chunk=min(512, a["seq"]))

    def run(policy):
        params = lm_train_params(cfg, dev, a["seed"])
        state = opt.adamw_init(flatten(params))
        with backends.autotune_policy(policy):
            params, state, metrics = step(params, state, batch)  # ---- path
        out = clones([metrics["loss"], params, state])
        return out, lambda: cuda_ms(lambda: step(params, state, batch),
                                    reps=1, repeats=3)
    return run


def mla_decode_path(cfg, params, dev):
    """Phase autotune_mla's path: `run(policy)` serves AUTOTUNE_MLA's
    one-token prompts through the slot engine on `cuda` for its 4 decode
    steps and returns the tokens and the latent caches, and a timer of one
    decode step."""
    a = AUTOTUNE_MLA
    prompts = np.random.default_rng(a["seed"]).integers(
        1, cfg.vocab_size, a["slots"])
    engine = make_engine("cuda")
    decode = make_decode_step(engine, cfg)

    def run(policy):
        server = ServingEngine(cfg, params, engine=engine, slots=a["slots"],
                               max_len=a["max_len"])
        reqs = [Request(rid=i, prompt=[int(t)], max_new=a["new"])
                for i, t in enumerate(prompts)]
        with backends.autotune_policy(policy):
            server.run(reqs)  # ---- the MLA decode path
        check(server.stats()["steps"] == a["new"]
              and all(len(r.out) == a["new"] for r in reqs),
              f"autotune_mla: {server.stats()['steps']} steps")
        out = [torch.tensor([r.out for r in reqs])] + clones(server.caches)
        toks = torch.tensor(prompts[:, None], dtype=torch.int64, device=dev)
        pos = torch.tensor(server.pos, dtype=torch.int64, device=dev)

        def step():
            with torch.inference_mode():
                decode(params, server.caches, toks, pos)
        return out, lambda: cuda_ms(step, reps=2, repeats=3)
    return run


def autotune_path(phase, name, run, smi) -> dict:
    """Run one path of phase autotune (see the module docstring) and check
    it; returns its per-path record."""
    runs = {}
    for label, policy in (("heuristic", "heuristic"), ("measured", "measure")):
        backends.clear_tile_cache()
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, timer = run(policy)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[label] = {"out": out, "report": backends.autotune_report(),
                       "launches": all_launches(), "wall_s": wall}
        del timer
    heur, meas = runs["heuristic"]["report"], runs["measured"]["report"]
    # A key an earlier path of the phase measured is served from the table
    measured = {k: r for k, r in meas.items() if r["source"] == "measured"}
    tuned = {k: r for k, r in meas.items() if r["source"] != "heuristic"}
    backends.clear_tile_cache()  # ---- a fresh process on the same device
    autotune.reset()
    reset_all_launches()
    out, timer = run("measure")
    torch.cuda.synchronize()
    # the measured run's counts include the candidates' timed launches
    fresh_launches = all_launches()
    fresh, stats = backends.autotune_report(), backends.cache_stats()
    # The path in turns on one card: "off" runs every rule's pick, and
    # "heuristic" serves the memoized (persisted, measured) picks.
    turns = {"off": [], "heuristic": []}
    for policy in ("off", "heuristic", "heuristic", "off"):
        with backends.autotune_policy(policy):
            turns[policy].append(timer())
    del timer
    backends.clear_tile_cache()
    heur_ms = statistics.mean(turns["off"])
    meas_ms = statistics.mean(turns["heuristic"])
    for key, rec in measured.items():
        hp = heur[key]["pick"]
        hms = next(ms for c, ms in rec["candidates_timed"] if c == hp)
        emit(phase + "_key", path=name, key=key, heuristic=hp,
             measured=rec["pick"], heuristic_ms=hms,
             measured_ms=rec["est_ms"], ratio=hms / rec["est_ms"],
             candidates_timed=rec["candidates_timed"])
    unregimed = [{k: v for k, v in launches.items()
                  if not k.startswith("gemm_fwd_regime")}
                 for launches in (runs["heuristic"]["launches"],
                                  fresh_launches)]
    decode = {k: r for k, r in meas.items()
              if k.startswith('["attention_decode"')}
    sources = collections.Counter(r["source"] for r in meas.values())
    rec = {"path": name, "keys": len(meas), "measured_keys": len(measured),
           "sources": dict(sources),
           "ops": dict(collections.Counter(json.loads(k)[0] for k in meas)),
           "heuristic_ms": heur_ms, "measured_ms": meas_ms,
           "ratio": heur_ms / meas_ms,
           "turns_ms": {"heuristic": turns["off"],
                        "measured": turns["heuristic"]},
           "changed_picks": sum(r["pick"] != heur[k]["pick"]
                                for k, r in tuned.items()),
           "fresh_stats": stats, "decode_keys": len(decode),
           "wall_s": {k: r["wall_s"] for k, r in runs.items()},
           "launches": fresh_launches, "smi": smi}
    emit(phase + "_path", **rec)
    check(same_bits(runs["heuristic"]["out"], runs["measured"]["out"]),
          f"{phase} {name}: the measured picks change the output bits")
    check(same_bits(runs["heuristic"]["out"], out),
          f"{phase} {name}: the persisted picks change the output bits")
    check(set(heur) == set(meas) == set(fresh),
          f"{phase} {name}: the keys differ between the runs")
    check(all(r["source"] == "heuristic" for r in heur.values()),
          f"{phase} {name}: a heuristic run measured or read the table")
    check(len(measured) > 0, f"{phase} {name}: no key was measured")
    check(stats["measured"] == 0 and stats["persisted"] == len(tuned)
          and all(fresh[k]["source"] == "persisted"
                  and fresh[k]["pick"] == r["pick"]
                  for k, r in tuned.items()),
          f"{phase} {name}: the fresh process {stats}, "
          f"{len(tuned)} keys measured or persisted")
    check(unregimed[0] == unregimed[1],
          f"{phase} {name}: launches differ beyond the regimes: "
          f"{unregimed}")
    check(all(r["source"] == "heuristic" and tuple(r["pick"])
              == ops.decode_splits(json.loads(k)[1][1][1],
                                   json.loads(k)[1][1][2])
              for k, r in decode.items()),
          f"{phase} {name}: a decode split moved: {decode}")
    return rec


def autotune_phase(phase, paths, smi) -> dict:
    """Phase autotune / autotune_mla: each (name, run) of `paths` through
    `autotune_path`, with the table in a fresh temporary directory; the
    cache cleared and the policy and environment restored after."""
    prev_env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    prev = backends.get_autotune_policy()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="autotune-") as table_dir:
            os.environ["REPRO_AUTOTUNE_CACHE"] = table_dir
            autotune.reset()
            recs = {name: autotune_path(phase, name, run, smi)
                    for name, run in paths}
            table = autotune.table_path()
            with open(table) as f:
                entries = len(json.load(f)["entries"])
    finally:
        if prev_env is None:
            os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
        else:
            os.environ["REPRO_AUTOTUNE_CACHE"] = prev_env
        backends.set_autotune_policy(prev)
        backends.clear_tile_cache()
        autotune.reset()
    emit(phase, seconds=time.perf_counter() - t0,
         fingerprint=autotune.device_fingerprint(), table_entries=entries,
         paths=list(recs), smi=smi)
    check(entries == sum(r["measured_keys"] for r in recs.values()),
          f"{phase}: {entries} table entries")
    return recs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    # ------------------------------------------------------------ 1. device
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=name, capability=list(cap), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    check(cap == (9, 0), f"need a Hopper card (capability 9.0), got {cap}")
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for lib in libs
             for ln in lib.with_name(lib.name + ".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln
             or "Compiling entry" in ln]
    emit("build", seconds=build_s, libraries=[p.name for p in libs],
         ptxas=ptxas)

    engine = make_engine("cuda")  # also turns TF32 off
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off")
    gen = torch.Generator().manual_seed(0)
    net = Network(DARKNET19_CFG, engine, generator=gen)
    randomize_bn(net, gen)
    cgen = torch.Generator(device=dev).manual_seed(1)
    peak_flops, peak_bw = card_peaks(name)

    # ------------------------------------------------------------- 2. check
    path_max_abs = 0.0
    for m, k, n in MATMUL_CASES:
        emit("check", **check_shape(m, k, n, gemm.PLANS, cgen))
    for batch in (1, 8):
        for g in path_gemms(net, batch):
            plans = (ops.default_tiles(g["m"], g["k"], g["n"]),)
            res = check_shape(g["m"], g["k"], g["n"], plans, cgen)
            path_max_abs = max(path_max_abs, res["max_abs_err_fp32"])
            emit("check", batch=batch, layer=g["layer"], **res)
    torch.cuda.synchronize()

    # ----------------------------------------------------------- 3. network
    logits_cfg = DARKNET19_CFG.replace("[softmax]", "")
    eager = make_engine("eager", device=dev)
    lg_cuda = Network(logits_cfg, engine)
    lg_eager = Network(logits_cfg, eager)
    prob_eager = Network(DARKNET19_CFG, eager)
    for other in (lg_cuda, lg_eager, prob_eager):
        other.load_state_dict(net.state_dict())
    x = torch.randn((2, *net.in_shape), generator=gen).to(dev)
    with torch.inference_mode():
        z_cuda, z_eager = lg_cuda(x), lg_eager(x)
        before = gemm.launches
        p_cuda = net(x)
        launches_per_forward = gemm.launches - before
        p_eager = prob_eager(x)
    torch.cuda.synchronize()
    check(tuple(z_cuda.shape) == (2, 1000), f"logits {tuple(z_cuda.shape)}")
    check(bool(torch.isfinite(z_cuda).all() and torch.isfinite(p_cuda).all()),
          "non-finite network output")
    logit_err, prob_err = relmax(z_cuda, z_eager), relmax(p_cuda, p_eager)
    check(logit_err <= LOGIT_TOL, f"logits cuda vs eager {logit_err:.3e}")
    check(prob_err <= PROB_TOL, f"probabilities cuda vs eager {prob_err:.3e}")
    check(bool(torch.allclose(p_cuda.sum(-1), torch.ones(2, device=dev),
                              atol=1e-5)), "probabilities do not sum to 1")
    check(launches_per_forward == 12,
          f"{launches_per_forward} kernel launches per forward, want 12")
    built = net.compile(2)
    want_plan = {("cuda", "conv2d"): 11, ("cuda", "matmul"): 1}
    check(built.op_counts == want_plan, f"op plan {built.op_counts}")
    check(built.trace_count == 1, f"{built.trace_count} builds")
    emit("network", cfg="DARKNET19_CFG", batch=2, logits_relmax=logit_err,
         probs_relmax=prob_err, logits_max_abs=float(z_cuda.abs().max()),
         launches_per_forward=launches_per_forward,
         op_counts={f"{b}.{o}": c for (b, o), c in built.op_counts.items()})

    # ------------------------------------------------------------- 4. serve
    cache = net.compile_cache(buckets=BUCKETS)
    server = CNNServingEngine(cache)
    rng = np.random.default_rng(0)
    h, w, c = net.in_shape
    bursts = []
    rid = 0
    for size in BURSTS:
        bursts.append([ImageRequest(rid=rid + i, image=rng.standard_normal(
            (h, w, c)).astype(np.float32)) for i in range(size)])
        rid += size
    gemm.reset_launches()
    backends.reset_dispatch_counts()
    for reqs in bursts:  # ---- the main path, driven once
        server.run(reqs)
    main_launches = gemm.launches
    main_dispatch = backends.dispatch_counts()
    st = server.stats()
    cs = st["cache"]
    check(main_launches > 0, "the main path launched no kernel")
    check(set(main_dispatch) == {("cuda", "conv2d"), ("cuda", "matmul")},
          f"main path dispatches {main_dispatch}")
    check(all(r.done and r.result is not None for b in bursts for r in b),
          "a request did not complete")
    check(st["requests"]["completed"] == rid == 33,
          f"{st['requests']['completed']} of {rid} requests completed")
    check(cs["misses"] == len(cs["compiled"]) == cs["traces"],
          f"builds {cs['misses']} / traces {cs['traces']} for "
          f"{len(cs['compiled'])} buckets")
    padded_rows = 0
    with torch.inference_mode():
        for reqs in bursts:
            for i in range(0, len(reqs), BUCKETS[-1]):
                chunk = reqs[i:i + BUCKETS[-1]]
                xb = torch.from_numpy(np.stack([r.image for r in chunk]))
                exact = net(xb.to(dev)).cpu().numpy()
                served = np.stack([r.result for r in chunk])
                check(np.array_equal(exact, served),
                      f"served rows differ from an exact batch of "
                      f"{len(chunk)}")
                if cache.bucket_for(len(chunk)) != len(chunk):
                    padded_rows += len(chunk)
    per_bucket = {}
    for b in BUCKETS:
        prof = cache.get(b).profile(reps=10)
        per_bucket[str(b)] = {"per_call_ms": prof["per_call_s"] * 1e3,
                              "images_per_s": b / prof["per_call_s"]}
    lat = st["latency_s"]
    emit("serve", requests=rid, completed=st["requests"]["completed"],
         steps=st["steps"], images_per_s=st["throughput"],
         p50_ms=lat["p50"] * 1e3, p99_ms=lat["p99"] * 1e3,
         buckets=list(cs["compiled"]), builds=cs["misses"],
         dispatches={str(k): v for k, v in cs["dispatches"].items()},
         pad_waste=cs["pad_waste"], bitwise_padded_rows=padded_rows,
         launches=main_launches, per_bucket=per_bucket)

    # ------------------------------------------------------------ 5. timing
    gemms = path_gemms(net, 8)
    logged = [backends.gemm_dims(r["op"], r["shapes"])
              for r in cache.get(8).op_log]
    check(logged == [(g["m"], g["k"], g["n"]) for g in gemms],
          f"planned GEMMs differ from the dispatched ones: {logged}")
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "ops_ms": 0.0, "bytes_ms": 0.0}
    for g in gemms:
        m, k, n = g["m"], g["k"], g["n"]
        x, w, scale, shift = operands(m, k, n, torch.float32, cgen)
        sc = scale if g["scale"] else None
        sh = shift if g["shift"] else None
        plan = ops.default_tiles(m, k, n)
        ms = cuda_ms(lambda: gemm.gemm_fused_fwd(x, w, sc, sh, act=g["act"],
                                                 plan=plan))
        plain_ms = cuda_ms(lambda: gemm.gemm_fused_plain(x, w, sc, sh,
                                                         act=g["act"]))
        library_ms = cuda_ms(lambda: torch.matmul(x, w))
        flops = 2.0 * m * k * n
        nbytes = 4.0 * (m * k + k * n + m * n + n * (int(g["scale"])
                                                     + int(g["shift"])))
        ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms), ("bound_ms", bound_ms),
                         ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
            totals[key] += val
        emit("timing", batch=8, layer=g["layer"], shape=[m, k, n],
             act=g["act"], plan=list(plan), ms=ms, plain_ms=plain_ms,
             library_ms=library_ms, bound_ms=bound_ms,
             bound_by="operations" if ops_ms >= bytes_ms else "bytes",
             tflops=flops / ms / 1e9, bound_share=bound_ms / ms)
    emit("timing_total", batch=8, gemms=len(gemms), smi=smi, **totals)

    # --------------------------------------------------------- 6. check_bwd
    bwd_max_abs = {"gemm_bwd_dx": 0.0, "gemm_bwd_dw": 0.0}
    res_max_abs = 0.0
    forced = [(p, s) for p in gemm.BWD_PLANS for s in (1, 3)]
    for m, k, n in MATMUL_CASES:
        emit("check_bwd", **check_res_shape(m, k, n, gemm.PLANS, cgen))
        emit("check_bwd", **check_bwd_shape(m, k, n, forced, forced, cgen))
        emit("check_bwd_bits", **check_bwd_bits(m, k, n, cgen))
    for g in path_gemms(net, TRAIN_BATCH):
        m, k, n = g["m"], g["k"], g["n"]
        res = check_res_shape(m, k, n, (ops.default_tiles(m, k, n),), cgen)
        res_max_abs = max(res_max_abs, res["max_abs_err_fp32"])
        emit("check_bwd", batch=TRAIN_BATCH, layer=g["layer"], **res)
        res = check_bwd_shape(m, k, n, *bwd_plans(m, k, n), cgen)
        for key in bwd_max_abs:
            bwd_max_abs[key] = max(bwd_max_abs[key],
                                   res["max_abs_err_fp32"][key])
        emit("check_bwd", batch=TRAIN_BATCH, layer=g["layer"], **res)
        emit("check_bwd_bits", batch=TRAIN_BATCH, layer=g["layer"],
             **check_bwd_bits(m, k, n, cgen))
    torch.cuda.synchronize()

    # ------------------------------------------------------------- 7. train
    tgen = torch.Generator().manual_seed(2)
    net_c = Network(DARKNET19_CFG, engine, generator=tgen)
    randomize_bn(net_c, tgen)
    net_e = Network(DARKNET19_CFG, eager)
    net_h = Network(DARKNET19_CFG, make_engine("eager", device="cpu"))
    net_e.load_state_dict(net_c.state_dict())
    net_h.load_state_dict(net_c.state_dict())
    rng = np.random.default_rng(3)
    host_batches = [(torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, *net_c.in_shape)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH)))
        for _ in range(TRAIN_STEPS)]
    batches = [(x.to(dev), y.to(dev)) for x, y in host_batches]
    loss_c1, grads_c = grads_of(net_c, batches[0])
    loss_e1, grads_e = grads_of(net_e, batches[0])
    _, grads_h = grads_of(net_h, host_batches[0])
    grad_err = {k: relmax(grads_c[k], grads_e[k]) for k in grads_e}
    grad_floor = {k: relmax(grads_h[k], grads_e[k]) for k in grads_e}
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1)
    train_gemms = path_gemms(net_c, TRAIN_BATCH)
    want_step = {**dict.fromkeys(gemm.launch_counts(), 0),
                 "gemm_fused_fwd_res": 12, "gemm_bwd_dx": 11,
                 "gemm_bwd_dw": 12}
    for i, g in enumerate(train_gemms):
        regime = ops.default_tiles(g["m"], g["k"], g["n"]).regime.lower()
        want_step[f"gemm_fwd_regime_{regime}"] += 1
        dx_plans, dw_plans = bwd_plans(g["m"], g["k"], g["n"])
        want_step["gemm_bwd_reduce"] += ((i > 0 and dx_plans[0][1] > 1)
                                         + (dw_plans[0][1] > 1))
    runs = {}
    for label, tnet, tbatches in (("cuda", net_c, batches),
                                  ("eager", net_e, batches),
                                  ("host", net_h, host_batches)):
        step = make_cnn_train_step(tnet, ocfg)
        state = opt.adamw_init(dict(tnet.named_parameters()))
        per_step, losses = [], []
        gemm.reset_launches()
        backends.reset_dispatch_counts()
        for batch in tbatches:  # ---- for "cuda": the training main path
            before = gemm.launch_counts()
            state, metrics = step(state, batch)
            after = gemm.launch_counts()
            per_step.append({k: after[k] - before[k] for k in after})
            losses.append(metrics["loss"].item())
        runs[label] = {"step": step, "state": state, "losses": losses,
                       "per_step": per_step,
                       "launches": gemm.launch_counts(),
                       "dispatch": backends.dispatch_counts(),
                       "params": dict(tnet.named_parameters())}
    torch.cuda.synchronize()
    cu, ea, ho = runs["cuda"], runs["eager"], runs["host"]
    train_launches = cu["launches"]
    err, floor = drift(cu, ea), drift(ho, ea)
    worst = {key: max(err[key].values()) for key in ("params", "moments")}
    worst_floor = {key: max(floor[key].values())
                   for key in ("params", "moments")}
    emit("train", cfg="DARKNET19_CFG", batch=TRAIN_BATCH, steps=TRAIN_STEPS,
         losses_cuda=cu["losses"], losses_eager=ea["losses"],
         losses_host=ho["losses"], loss_rel_err=err["loss"],
         loss_rel_floor=floor["loss"],
         step1_loss_rel_err=abs(loss_c1.item() - loss_e1.item())
         / abs(loss_e1.item()),
         grad_relmax_worst=max(grad_err.values()),
         grad_floor_worst=max(grad_floor.values()),
         param_relmax_worst=worst["params"],
         param_floor_worst=worst_floor["params"],
         moment_relmax_worst=worst["moments"],
         moment_floor_worst=worst_floor["moments"],
         floor_factor=FLOOR_FACTOR, grad_relmax=grad_err,
         param_relmax=err["params"], param_floor=floor["params"],
         launches_per_step=cu["per_step"], launches=train_launches,
         want_per_step=want_step,
         eager_launches=ea["launches"], host_launches=ho["launches"],
         dispatch={f"{b}.{o}": c for (b, o), c in cu["dispatch"].items()})
    check(all(math.isfinite(x) for x in cu["losses"]), "non-finite loss")
    check(err["loss"][0] <= FP32_TOL,
          f"step-1 loss cuda vs eager {err['loss'][0]:.3e} > {FP32_TOL:g}")
    check(len(grad_err) == 57, f"{len(grad_err)} gradients, want 57")
    check(max(grad_err.values()) <= TRAIN_TOL,
          f"step-1 gradient cuda vs eager {max(grad_err.values()):.3e}")
    for i, (e, f) in enumerate(zip(err["loss"], floor["loss"])):
        check(e <= max(FP32_TOL, FLOOR_FACTOR * f),
              f"step-{i + 1} loss cuda vs eager {e:.3e}, host vs eager "
              f"{f:.3e}")
    for key in ("params", "moments"):
        check(worst[key] <= max(TRAIN_TOL, FLOOR_FACTOR * worst_floor[key]),
              f"{key} after {TRAIN_STEPS} steps: cuda vs eager "
              f"{worst[key]:.3e}, host vs eager {worst_floor[key]:.3e}")
    check(all(c == want_step for c in cu["per_step"]),
          f"launches per step {cu['per_step']}, want {want_step}")
    check(sum(ea["launches"].values()) + sum(ho["launches"].values()) == 0,
          "the eager engines launched a kernel of the port")
    check(cu["dispatch"] == {("cuda", "conv2d"): 11 * TRAIN_STEPS,
                             ("cuda", "matmul"): TRAIN_STEPS},
          f"train path dispatches {cu['dispatch']}")
    del net_h, grads_h, host_batches

    # ------------------------------------------------------ 8. timing_train
    tt = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                 "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0}
          for name in ("gemm_fused_fwd_res", "gemm_bwd_dx", "gemm_bwd_dw")}

    def record(name, layer, shape, flops, nbytes, fn, plain, library,
               **extra):
        ms, plain_ms, library_ms = cuda_ms(fn), cuda_ms(plain), cuda_ms(
            library)
        bound_ms, bound_by = bound(flops, nbytes, peak_flops, peak_bw)
        row = tt[name]
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["library_ms"] += library_ms
        row["bound_ms"] += bound_ms
        row["ops_ms"] += flops / peak_flops * 1e3
        row["bytes_ms"] += nbytes / peak_bw * 1e3
        emit("timing_train", kernel=name, batch=TRAIN_BATCH, layer=layer,
             shape=shape, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=bound_ms, bound_by=bound_by,
             tflops=flops / ms / 1e9, bound_share=bound_ms / ms, **extra)

    for i, g in enumerate(train_gemms):
        m, k, n, act = g["m"], g["k"], g["n"], g["act"]
        x, w, scale, shift = operands(m, k, n, torch.float32, cgen)
        dy = torch.randn(m, n, generator=cgen, device=dev)
        sc = scale if g["scale"] else None
        sh = shift if g["shift"] else None
        plan = ops.default_tiles(m, k, n)
        res_out = 1 + (act != "linear") + int(g["scale"])
        record("gemm_fused_fwd_res", g["layer"], [m, k, n], 2.0 * m * k * n,
               4.0 * (m * k + k * n + res_out * m * n
                      + n * (int(g["scale"]) + int(g["shift"]))),
               lambda: gemm.gemm_fused_fwd(x, w, sc, sh, act=act, plan=plan,
                                           residuals=True),
               lambda: gemm.gemm_fused_res_plain(x, w, sc, sh, act=act),
               lambda: torch.matmul(x, w), plan=list(plan))
        (dx_plan,), (dw_plan,) = bwd_plans(m, k, n)
        if i > 0:  # the first layer's input is the image: no dX
            record("gemm_bwd_dx", g["layer"], [m, n, k], 2.0 * m * k * n,
                   4.0 * (m * n + k * n + m * k),
                   lambda: gemm.gemm_bwd_dx(dy, w, plan=dx_plan[0],
                                            splits=dx_plan[1]),
                   lambda: gemm.gemm_bwd_dx_plain(dy, w),
                   lambda: torch.matmul(dy, w.t()), plan=dx_plan[0],
                   splits=dx_plan[1])
        record("gemm_bwd_dw", g["layer"], [k, m, n], 2.0 * m * k * n,
               4.0 * (m * k + m * n + k * n),
               lambda: gemm.gemm_bwd_dw(x, dy, plan=dw_plan[0],
                                        splits=dw_plan[1]),
               lambda: gemm.gemm_bwd_dw_plain(x, dy),
               lambda: torch.matmul(x.t(), dy), plan=dw_plan[0],
               splits=dw_plan[1])
    emit("timing_train_total", batch=TRAIN_BATCH, smi=smi, **tt)
    del x, w, dy
    def run_step(label, batch):
        runs[label]["state"], _ = runs[label]["step"](runs[label]["state"],
                                                      batch)

    steps = {}
    for batch_size in (TRAIN_BATCH, BIG_BATCH):
        images = torch.randn((batch_size, *net_c.in_shape), generator=cgen,
                             device=dev)
        labels = torch.randint(0, 1000, (batch_size,), generator=cgen,
                               device=dev)
        for label in ("cuda", "eager"):
            torch.cuda.reset_peak_memory_stats(dev)
            ms = host_ms(lambda: run_step(label, (images, labels)))
            steps[f"{label}_b{batch_size}"] = {
                "ms": ms, "images_per_s": batch_size / ms * 1e3,
                "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        del images, labels
    # The cuda step at TRAIN_BATCH in two parts: forward + backward, then
    # clipping + AdamW over the 57 parameter tensors.
    grads = grads_of(net_c, batches[0])[1]
    parts = {"forward_backward_ms": host_ms(lambda: grads_of(net_c,
                                                             batches[0])),
             "optimizer_ms": host_ms(lambda: opt.adamw_update(
                 ocfg, opt.clip_by_global_norm(grads, ocfg.clip_norm)[0],
                 cu["state"], cu["params"]))}
    kernel_ms = sum(row["ms"] for row in tt.values())
    emit("timing_train_step", smi=smi, steps=steps, batch=TRAIN_BATCH,
         kernel_ms=kernel_ms, **parts,
         kernel_share=kernel_ms / steps[f"cuda_b{TRAIN_BATCH}"]["ms"])

    # ------------------------------------------------------ 9-15. the LM
    attn_abs = attn_phases(cgen)
    cfg = get_arch(LM_ARCH)
    lm_gemm_abs = lm_gemm_check(cfg, cgen)
    regimes_phase(cgen)
    lm_gemm = lm_gemm_timing(cfg, cgen, peak_flops, peak_bw, smi)
    params = lm_params(cfg, dev)
    lm = lm_phase(cfg, params, dev)
    serve_lm = lm_serve_phase(cfg, params, dev, lm["abs_err"])
    lm_rows = timing_lm_phase(cfg, params, dev, cgen, peak_flops, peak_bw,
                              serve_lm, smi)
    bucket_phase(cfg, params, dev)
    lm_mixed_phase(cfg, params, dev)
    lm_launches = serve_lm["launches"]
    del params, serve_lm
    torch.cuda.empty_cache()

    # --------------------------------------------- 63-65. serving on a mesh
    sh_abs = check_sharded_phase(cfg)
    sh_serve = sharded_serve_phase(cfg, lm["abs_err"], smi)
    sh_rows = timing_sharded_phase(cfg, dev, peak_flops, peak_bw, smi)

    # --------------------------------------------------- 16-19. LM training
    bwd_abs = attn_bwd_phase(cgen)
    bwd_dims_abs = attn_bwd_dims_phase(dev)
    tl = lm_train_phase(cfg, dev)
    lm_restart_phase(dev)
    train_rows = timing_lm_train_phase(cfg, dev, cgen, peak_flops, peak_bw,
                                       smi, tl)
    torch.cuda.empty_cache()
    autotune_phase("autotune", (("cnn_serve", cnn_serve_path(dev)),
                                ("cnn_train", cnn_train_path(dev)),
                                ("lm_train", lm_train_path(cfg, dev))), smi)
    torch.cuda.empty_cache()

    # ------------------------------------------------------ 20-23. the SSM
    scfg = get_arch(SSM_ARCH)
    ssd_abs = check_ssd_phase(scfg, cgen)
    sparams = ssm_params(scfg, dev)
    ssm_abs = ssm_phase(scfg, sparams, dev)
    serve_ssm = ssm_serve_phase(scfg, sparams, dev, ssm_abs)
    ssm_rows = timing_ssm_phase(scfg, sparams, dev, cgen, peak_flops,
                                peak_bw, smi)
    lm_mixed_phase(scfg, sparams, dev)
    del sparams
    torch.cuda.empty_cache()
    tgen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    ssm_tr = family_train_phase("ssm_train", scfg, dev, SSM_TRAIN, tgen)
    timing_family_train_phase("ssm_train", scfg, dev, SSM_TRAIN, tgen,
                              peak_flops, peak_bw, smi, ssm_tr["launches"])
    torch.cuda.empty_cache()

    # ------------------------------------ 24-28. the bmm op, the direct conv
    bmm_abs = check_bmm_phase(cgen)
    eb = engine_bmm_phase(dev)
    bmm_rows = timing_bmm_phase(cgen, peak_flops, peak_bw, smi)
    figure3_phase(cgen, peak_flops, peak_bw, smi)
    torch.cuda.empty_cache()
    conv = conv_direct_phase(net, cgen, peak_flops, peak_bw, smi)

    # ----------------------------------------------------- 31-34. the MoE
    torch.cuda.empty_cache()
    mcfg = moe_cfg()
    moe_abs = check_moe_phase(mcfg, cgen)
    mparams = moe_params(mcfg, dev)
    moe_run = moe_phase(mcfg, mparams, dev)
    serve_moe = moe_serve_phase(mcfg, mparams, dev, moe_run["abs_err"])
    moe_rows = timing_moe_phase(mcfg, mparams, dev, cgen, peak_flops,
                                peak_bw, smi, serve_moe)
    del mparams
    torch.cuda.empty_cache()

    # ------------------------------------------------ 35-40. the frontends
    vcfg = get_arch(VLM_ARCH)
    b, text = VLM_PREFILL
    s = vcfg.frontend_tokens + text
    vchk = check_frontends_phase(
        vcfg, cgen, {"frontend": b * vcfg.frontend_tokens, "head": b},
        {"vlm_prefill": (b, s, s, None, True)},
        {"vlm_decode": (b, 1, s + VLM_DECODE_STEPS, [s + 1, s - 20],
                        False)})
    vparams = frontend_params(vcfg, dev, 33)
    vlm = vlm_phase(vcfg, vparams, dev)
    vt = timing_vlm_phase(vcfg, vparams, dev, cgen, peak_flops, peak_bw,
                          smi)
    del vparams
    torch.cuda.empty_cache()
    acfg = get_arch(AUDIO_ARCH)
    b, s = AUDIO_FRAMES
    achk = check_frontends_phase(
        acfg, cgen, {"frontend": b * s, "head": b},
        {"audio_forward": (b, s, s, None, False)}, {})
    aparams = frontend_params(acfg, dev, 43)
    aud = audio_phase(acfg, aparams, dev)
    at = timing_audio_phase(acfg, aparams, dev, cgen, peak_flops, peak_bw,
                            smi)
    del aparams
    torch.cuda.empty_cache()
    # `ref` computes `eager`'s bits for hubert (its attention oracle and
    # eager's take the same ops at G = 1), so its floor run takes each
    # batch in two microbatches: the same function, summed in another order
    aud_tr = family_train_phase(
        "audio_train", acfg, dev, AUDIO_TRAIN, tgen,
        data=lambda i: audio_batch(acfg, dev, AUDIO_TRAIN, i),
        floor_step={"num_microbatches": 2})
    aud_tt = timing_family_train_phase("audio_train", acfg, dev, AUDIO_TRAIN,
                                       tgen, peak_flops, peak_bw, smi,
                                       aud_tr["launches"])
    torch.cuda.empty_cache()

    # ---------------------------------------------------- 41-44. the hybrid
    hcfg = get_arch(HYBRID_ARCH)
    hchk = check_hybrid_phase(hcfg, cgen)
    hparams = hybrid_params(hcfg, dev)
    hyb = hybrid_phase(hcfg, hparams, dev)
    hybrid_serve_phase(hcfg, hparams, dev)
    ht = timing_hybrid_phase(hcfg, hparams, dev, cgen, peak_flops, peak_bw,
                             smi)
    del hparams
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(hcfg, n_layers=HYBRID_TRAIN["layers"])
    hyb_tr = family_train_phase("hybrid_train", tcfg, dev, HYBRID_TRAIN,
                                tgen)
    hyb_tt = timing_family_train_phase("hybrid_train", tcfg, dev,
                                       HYBRID_TRAIN, tgen, peak_flops,
                                       peak_bw, smi, hyb_tr["launches"])
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 45-48. MLA
    lcfg = get_arch(MLA_ARCH)
    mgen = torch.Generator(device=dev).manual_seed(MLA_SEED)
    lchk = check_mla_phase(lcfg, mgen)
    lparams = mla_params(lcfg, dev)
    mla = mla_phase(lcfg, lparams, dev)
    mla_serve_phase(lcfg, lparams, dev, mla["abs_err"])
    short = mla_serve_phase(lcfg, lparams, dev, mla["abs_err"],
                            phase="mla_short_serve", max_len=None)
    chunk = mla_chunk_phase(lcfg, lparams, dev)
    lt = timing_mla_phase(lcfg, lparams, dev, mgen, peak_flops, peak_bw,
                          smi)
    lt576 = timing_mla_576(lcfg, dev, peak_flops, peak_bw, smi)
    autotune_phase("autotune_mla",
                   (("mla_decode", mla_decode_path(lcfg, lparams, dev)),),
                   smi)
    del lparams
    torch.cuda.empty_cache()

    # ---------------------------------------- 56-58. training the MoE programs
    tcfg = dataclasses.replace(lcfg, n_layers=MLA_TRAIN["layers"])
    ggen = torch.Generator(device=dev).manual_seed(MLA_TRAIN["gen"])
    # `ref` computes `eager`'s bits here too, so its trajectory takes the CE
    # in chunks of 256 (make_train_step on train_loop's batches): the same
    # loss summed in another order; microbatches would split the routing
    # groups' load-balance loss, another function
    mla_tr = family_train_phase(
        "mla_train", tcfg, dev, MLA_TRAIN, ggen,
        data=lambda i: lm_train_batch(tcfg, dev, i, MLA_TRAIN["batch"],
                                      MLA_TRAIN["seq"], MLA_TRAIN["seed"]),
        floor_step={"ce_chunk": 256})
    mla_tt = timing_family_train_phase("mla_train", tcfg, dev, MLA_TRAIN,
                                       ggen, peak_flops, peak_bw, smi,
                                       mla_tr["launches"])
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(get_arch(MOE_ARCH),
                               n_layers=MOE_TRAIN["layers"])
    ggen = torch.Generator(device=dev).manual_seed(MOE_TRAIN["gen"])
    moe_tr = family_train_phase("moe_train", tcfg, dev, MOE_TRAIN, ggen)
    moe_tt = train_bmm_rows("moe_train", tcfg, MOE_TRAIN, ggen, peak_flops,
                            peak_bw, smi, moe_tr["step_launches"])
    torch.cuda.empty_cache()

    def kernel_entry(name, source, replaces, path, launches, max_abs_err,
                     row):
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "path": path, "checked": True,
                 "launches": launches, "max_abs_err": max_abs_err,
                 "ms": row["ms"], "plain_ms": row["plain_ms"],
                 "bound_ms": row["bound_ms"],
                 "bound_by": ("operations" if row["ops_ms"] >= row["bytes_ms"]
                              else "bytes"),
                 "library_ms": row["library_ms"]}
        if "op_ms" in row:
            entry["op_ms"] = row["op_ms"]
        return entry

    print(json.dumps({"kernels": [
        kernel_entry("gemm_fused_fwd", SOURCE, REPLACES, "cnn_serve",
                     main_launches, path_max_abs, totals),
        kernel_entry("gemm_fused_fwd_res", SOURCE, REPLACES, "cnn_train",
                     train_launches["gemm_fused_fwd_res"], res_max_abs,
                     tt["gemm_fused_fwd_res"]),
        kernel_entry("gemm_bwd_dx", SOURCE_BWD, REPLACES_DX, "cnn_train",
                     train_launches["gemm_bwd_dx"],
                     bwd_max_abs["gemm_bwd_dx"], tt["gemm_bwd_dx"]),
        kernel_entry("gemm_bwd_dw", SOURCE_BWD, REPLACES_DW, "cnn_train",
                     train_launches["gemm_bwd_dw"],
                     bwd_max_abs["gemm_bwd_dw"], tt["gemm_bwd_dw"]),
        kernel_entry("gemm_fused_fwd:lm", SOURCE, REPLACES, "lm_serve",
                     lm_launches["gemm_fused_fwd"], lm_gemm_abs, lm_gemm),
        kernel_entry("flash_attention", SOURCE_ATTN, REPLACES_ATTN,
                     "lm_serve", lm_launches["flash_attention"],
                     attn_abs["attn"], lm_rows["prefill_chunk"]),
        kernel_entry("flash_decode", SOURCE_DECODE, REPLACES_DECODE,
                     "lm_serve", lm_launches["flash_decode"],
                     attn_abs["decode"], lm_rows["decode_b8"]),
        kernel_entry("gemm_fused_fwd_res:lm", SOURCE, REPLACES, "lm_train",
                     tl["gemm_fused_fwd_res"],
                     train_rows["gemm"]["gemm_fused_fwd_res"]["max_abs_err"],
                     train_rows["gemm"]["gemm_fused_fwd_res"]),
        kernel_entry("gemm_bwd_dx:lm", SOURCE_BWD, REPLACES_DX, "lm_train",
                     tl["gemm_bwd_dx"],
                     train_rows["gemm"]["gemm_bwd_dx"]["max_abs_err"],
                     train_rows["gemm"]["gemm_bwd_dx"]),
        kernel_entry("gemm_bwd_dw:lm", SOURCE_BWD, REPLACES_DW, "lm_train",
                     tl["gemm_bwd_dw"],
                     train_rows["gemm"]["gemm_bwd_dw"]["max_abs_err"],
                     train_rows["gemm"]["gemm_bwd_dw"]),
        kernel_entry("flash_attention_lse", SOURCE_ATTN, REPLACES_ATTN,
                     "lm_train", tl["flash_attention_lse"],
                     max(bwd_abs["o"], bwd_abs["lse"]),
                     train_rows["attn"]["flash_attention_lse"]),
        kernel_entry("flash_attention_bwd_dq", SOURCE_ATTN_BWD, REPLACES_DQ,
                     "lm_train", tl["flash_attention_bwd_dq"],
                     bwd_abs["dq"],
                     train_rows["attn"]["flash_attention_bwd_dq"]),
        kernel_entry("flash_attention_bwd_dkv", SOURCE_ATTN_BWD,
                     REPLACES_DKV, "lm_train",
                     tl["flash_attention_bwd_dkv"],
                     max(bwd_abs["dk"], bwd_abs["dv"]),
                     train_rows["attn"]["flash_attention_bwd_dkv"]),
        kernel_entry("ssd_scan", SOURCE_SSD, REPLACES_SSD, "ssm_serve",
                     serve_ssm["launches"]["ssd_scan"], ssd_abs["serve"],
                     ssm_rows["ssd"]["serve"]),
        kernel_entry("bmm_fwd", SOURCE, REPLACES_BMM, "engine_bmm",
                     eb["launches"]["bmm_fwd"], bmm_abs["bmm_fwd"],
                     bmm_rows["bmm_fwd"]),
        kernel_entry("bmm_bwd_dx", SOURCE_BWD, REPLACES_BMM_DX,
                     "engine_bmm", eb["launches"]["bmm_bwd_dx"],
                     bmm_abs["bmm_bwd_dx"], bmm_rows["bmm_bwd_dx"]),
        kernel_entry("bmm_bwd_dw", SOURCE_BWD, REPLACES_BMM_DW,
                     "engine_bmm", eb["launches"]["bmm_bwd_dw"],
                     bmm_abs["bmm_bwd_dw"], bmm_rows["bmm_bwd_dw"]),
        kernel_entry("conv2d_direct", SOURCE_CONV, REPLACES_CONV,
                     "conv_direct", conv["launches"], conv["max_abs_err"],
                     conv["total"]),
        kernel_entry("gemm_fused_fwd:moe", SOURCE, REPLACES, "moe_serve",
                     serve_moe["launches"]["gemm_fused_fwd"],
                     moe_abs["gemm"], moe_rows["gemm"]),
        kernel_entry("bmm_fwd:moe", SOURCE, REPLACES_BMM, "moe_serve",
                     serve_moe["launches"]["bmm_fwd"], moe_abs["bmm"],
                     moe_rows["bmm"]["decode_b4_or_prefill_2x128"]),
        kernel_entry("gemm_fused_fwd:vlm", SOURCE, REPLACES, "vlm",
                     vlm["launches"]["gemm_fused_fwd"], vchk["gemm"],
                     vt["gemm"]),
        kernel_entry("flash_attention:vlm", SOURCE_ATTN, REPLACES_ATTN, "vlm",
                     vlm["launches"]["flash_attention"], vchk["attn"],
                     vt["attention"]["vlm_prefill"]),
        kernel_entry("flash_decode:vlm", SOURCE_DECODE, REPLACES_DECODE,
                     "vlm", vlm["launches"]["flash_decode"], vchk["decode"],
                     vt["attention"]["vlm_decode"]),
        kernel_entry("gemm_fused_fwd:audio", SOURCE, REPLACES, "audio",
                     aud["launches"]["gemm_fused_fwd"], achk["gemm"],
                     at["gemm"]),
        kernel_entry("flash_attention:audio", SOURCE_ATTN, REPLACES_ATTN,
                     "audio", aud["launches"]["flash_attention"],
                     achk["attn"], at["attention"]["audio_forward"]),
        kernel_entry("gemm_fused_fwd:hybrid", SOURCE, REPLACES, "hybrid",
                     hyb["launches"]["gemm_fused_fwd"], hchk["gemm"],
                     ht["gemm"]),
        kernel_entry("flash_attention:hybrid", SOURCE_ATTN, REPLACES_ATTN,
                     "hybrid", hyb["launches"]["flash_attention"],
                     hchk["attn"], ht["attention"]["hybrid_prefill"]),
        kernel_entry("flash_decode:hybrid", SOURCE_DECODE, REPLACES_DECODE,
                     "hybrid", hyb["launches"]["flash_decode"],
                     hchk["decode"], ht["attention"]["hybrid_decode"]),
        kernel_entry("ssd_scan:hybrid", SOURCE_SSD, REPLACES_SSD, "hybrid",
                     hyb["launches"]["ssd_scan"], hchk["ssd"], ht["ssd"]),
        kernel_entry("gemm_fused_fwd:mla", SOURCE, REPLACES, "mla",
                     mla["launches"]["gemm_fused_fwd"], lchk["gemm"],
                     lt["gemm"]),
        kernel_entry("bmm_fwd:mla", SOURCE, REPLACES_BMM, "mla",
                     mla["launches"]["bmm_fwd"], lchk["bmm"], lt["expert"]),
        kernel_entry("flash_attention:mla", SOURCE_ATTN, REPLACES_ATTN, "mla",
                     mla["launches"]["flash_attention"], lchk["attn"],
                     lt["attention"]["mla_prefill"]),
        kernel_entry("flash_decode:mla", SOURCE_DECODE, REPLACES_DECODE,
                     "mla", mla["launches"]["flash_decode"], lchk["decode"],
                     lt["attention"]["mla_decode"]),
        kernel_entry("flash_attention:mla_short_serve", SOURCE_ATTN,
                     REPLACES_ATTN, "mla_short_serve",
                     short["launches"]["flash_attention"], lchk["attn_576"],
                     lt576["mla_short_step"]),
        kernel_entry("flash_attention:mla_chunk", SOURCE_ATTN, REPLACES_ATTN,
                     "mla_chunk", chunk["launches"]["flash_attention"],
                     lchk["attn_576"], lt576["mla_chunk"]),
        *(kernel_entry(f"{name}:{path}", source, replaces, path,
                       tr["launches"][name], max(
                           bwd_dims_abs[d][key] for key in keys),
                       tt[name])
          for d, path, tr, tt in ((80, "audio_train", aud_tr, aud_tt),
                                  (112, "hybrid_train", hyb_tr, hyb_tt),
                                  (192, "mla_train", mla_tr, mla_tt))
          for name, source, replaces, keys in (
              ("flash_attention_lse", SOURCE_ATTN, REPLACES_ATTN,
               ("o", "lse")),
              ("flash_attention_bwd_dq", SOURCE_ATTN_BWD, REPLACES_DQ,
               ("dq",)),
              ("flash_attention_bwd_dkv", SOURCE_ATTN_BWD, REPLACES_DKV,
               ("dk", "dv")))),
        *(kernel_entry(f"{name}:{path}", SOURCE_BWD, replaces, path,
                       tr["launches"][name], tr["gemm_abs"][name], tt[name])
          for path, tr, tt in (("mla_train", mla_tr, mla_tt),
                               ("moe_train", moe_tr, moe_tt))
          for name, replaces in (("bmm_bwd_dx", REPLACES_BMM_DX),
                                 ("bmm_bwd_dw", REPLACES_BMM_DW))),
        kernel_entry("gemm:sharded_serve", SOURCE, REPLACES, "sharded_serve",
                     sh_serve["slot_batch"]["launches"]["gemm_fused_fwd"],
                     sh_abs["gemm_fused_fwd"], sh_rows["gemm"]),
        kernel_entry("flash_decode:sharded_serve", SOURCE_DECODE,
                     REPLACES_DECODE, "sharded_serve",
                     sh_serve["slot_batch"]["launches"]["flash_decode"],
                     sh_abs["flash_decode"], sh_rows["decode"]),
        kernel_entry("flash_attention_lse:sharded_seq", SOURCE_ATTN,
                     REPLACES_ATTN, "sharded_serve",
                     sh_serve["slot_seq"]["launches"]["flash_attention_lse"],
                     sh_abs["flash_attention_lse"], sh_rows["lse"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
