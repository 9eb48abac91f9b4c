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
              head dims 32/64/128, fp32 and bf16; then qwen2-0.5b's shapes
              (prefill chunks at batch 1 and 4, a 512-token prompt, the
              training shape, shallow decode).  Rows with no live key must
              be exactly 0.  Bars as phase 2.  At every case every forward
              plan (flash_attention.PLANS), with and without lse, gives the
              path plan's bits, and the lse launch's o the serving
              launch's.
 10. check_decode  the split-KV decode kernel's partials and empty-span
              sentinels against its plain version over Sq 1/4/8 against
              Skv 256/1024 and qwen2-0.5b's decode shapes; the launch that
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
Then the kernels line, and last the result line.  Every JSON line carries
`t`, the seconds since the script started.
"""
from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.base import (ShapeConfig, get_arch,  # noqa: E402
                                       reduced)
from repro_torch.configs.darknet_ref import DARKNET19_CFG  # noqa: E402
from repro_torch.core import backends, make_engine  # noqa: E402
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
from repro_torch.launch.fault import FailureInjected  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve import kvcache, kvpool  # noqa: E402
from repro_torch.serve.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serve.scheduler import PagedServingEngine  # noqa: E402
from repro_torch.serve.serve_step import (make_decode_step,  # noqa: E402
                                          make_paged_step, make_prefill_step)
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
_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - _T0,
                                                 1), **fields}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def relmax(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().to(a.device).double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


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


def check_bwd_shape(m, k, n, dx_plans, dw_plans, gen) -> dict:
    """dX = dY W^T and dW = X^T dY vs their plain versions at the forward
    shape (m, k, n), over in/out dtypes and (plan, splits) pairs; a dW run
    twice must give the same bits."""
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
            tol = FP32_TOL if kind == "fp32" else BF16_TOL
            for name, fn, plain, a, b, plans in (
                    ("gemm_bwd_dx", gemm.gemm_bwd_dx, gemm.gemm_bwd_dx_plain,
                     dy, w, dx_plans),
                    ("gemm_bwd_dw", gemm.gemm_bwd_dw, gemm.gemm_bwd_dw_plain,
                     x, dy, dw_plans)):
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
    """Every kernel wrapper's launch count, by kernel name."""
    return {**gemm.launch_counts(), **fa.launch_counts(),
            "flash_decode": fd.launches, "ssd_scan": ssd.launches,
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
    """Every forward plan, with and without lse, against the path plan's
    outputs at one case, bit for bit; returns the outputs compared."""
    o_lse, lse = fa.flash_attention_fwd(q, k, v, kvl, causal=causal,
                                        return_lse=True)
    check(torch.equal(o_lse, got), f"the lse launch's o differs at {where}")
    for plan in fa.PLANS:
        o = fa.flash_attention_fwd(q, k, v, kvl, causal=causal, plan=plan)
        o2, lse2 = fa.flash_attention_fwd(q, k, v, kvl, causal=causal,
                                          return_lse=True, plan=plan)
        check(torch.equal(o, got) and torch.equal(o2, got)
              and torch.equal(lse2, lse),
              f"forward plan {plan} differs from the path plan's bits at "
              f"{where}")
    return 3 * len(fa.PLANS)


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


def attn_phases(cgen) -> dict:
    """Phases check_attn and check_decode; returns the fp32 max-abs errors
    at qwen2-0.5b's shapes."""
    worst = {"attn": {"fp32": 0.0, "bf16": 0.0},
             "decode": {"fp32": 0.0, "bf16": 0.0}}
    path_abs = {"attn": 0.0, "decode": 0.0, "merge": 0.0}
    dev = cgen.device
    cases = bits = dec_bits = 0
    for h, kv in HEAD_RATIOS:
        for d in (32, 64, 128):
            for dt in (torch.float32, torch.bfloat16):
                kind = "fp32" if dt == torch.float32 else "bf16"
                for sq in (1, 4, 16):
                    for skv in (64, 256):
                        q, k, v = qkv(2, sq, skv, h, kv, d, dt, cgen)
                        kvl = torch.tensor([skv // 2 + 3, 0],
                                           dtype=torch.int32, device=dev)
                        for causal in (True, False):
                            for lens in (None, kvl):
                                err, _, n = check_attn_case(q, k, v, lens,
                                                            causal)
                                bits += n
                                worst["attn"][kind] = max(
                                    worst["attn"][kind], err)
                                cases += 1
                for sq in (1, 4, 8):
                    for skv in (256, 1024):
                        q, k, v = qkv(3, sq, skv, h, kv, d, dt, cgen)
                        kvl = torch.tensor([skv, skv // 3, 0],
                                           dtype=torch.int32, device=dev)
                        for causal in (True, False):
                            err, _, _, n, _ = check_decode_case(q, k, v, kvl,
                                                                causal)
                            dec_bits += n
                            worst["decode"][kind] = max(
                                worst["decode"][kind], err)
    torch.cuda.synchronize()
    emit("check_attn", grid_cases=cases, relmax=worst["attn"],
         plans=[list(p) for p in fa.PLANS], plan_outputs_bitwise=bits)
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
                         "plan": list(fa.plan_for(b, sq, h, kv))})
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


def lm_gemm_timing(cfg, cgen, peak_flops, peak_bw, smi) -> dict:
    """Phase timing_lm_gemm: each LM GEMM at M 1, 8 and 64, fp32 with its
    epilogue: the kernel, its plain version and torch.matmul (cuBLAS fp32,
    TF32 off, no epilogue), each the device time of CUDA-graph replays,
    and the bound.  As on the path, each timed call runs the GEMM once
    per layer over that many distinct weights, so the weights come from
    device memory and not from the 50 MB L2.  Sums per dispatch (24
    layers x 7 + the head) at each M, and their total over the three."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms",
            "bytes_ms")
    total = dict.fromkeys(keys, 0.0)
    per_m = {}
    for m in LM_GEMM_ROWS:
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
            emit("timing_lm_gemm", m=m, gemm=g["name"], shape=[m, k, n],
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
    emit("timing_lm_gemm_total", smi=smi, per_dispatch=per_m,
         launches_per_dispatch=sum(g["per_dispatch"] for g in lm_gemms(cfg)),
         **total)
    return total


def lm_params(cfg, dev):
    """Full-width random parameters from a seed, with random QKV biases
    (the init's zeros would leave the bias epilogue untested)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    params = tfm.init_params(cfg, generator=gen, device=dev)
    with torch.no_grad():
        for lp in params["layers"]:
            for name in ("bq", "bk", "bv"):
                b = lp["attn"][name]
                b.copy_(torch.randn(b.shape, generator=gen, device=dev) * 0.1)
    return params


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
            logits, caches = make_prefill_step(eng, cfg)(params, tokens)
            buf = kvcache.cache_init(cfg, 1, LM_CACHE, device=dev)
            for name in ("k", "v"):
                buf[0][name][:, :, :LM_PREFILL] = caches[0][name]
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
            h = tfm.forward_hidden(eager, cfg, params, tokens=torch.tensor(
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


def timing_lm_phase(cfg, params, dev, cgen, peak_flops, peak_bw,
                    serve: dict, smi: str) -> dict:
    """Phase timing_lm: the attention kernels at the path's shapes and the
    paged step's dispatch times."""
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = {}
    for name, (b, sq, skv, lens, causal) in {
            "prefill_chunk": (1, 64, LM_CACHE, [576], True),
            "prompt_2048": (1, 2048, 2048, None, True),
            "decode_b8": (8, 1, LM_CACHE, [LM_CACHE] * 8, False),
            "decode_b1": (1, 1, LM_CACHE, [LM_CACHE], False)}.items():
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
            extra = {"plan": list(fa.plan_for(b, sq, h, kv)),
                     "plans_ms": {str(tuple(p)): graph_ms(
                         lambda p=p: fa.flash_attention_fwd(
                             q, k, v, kvl, causal=causal, plan=p))
                         for p in fa.PLANS}}
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
        emit("timing_lm", name=name, smi=smi, **row)
        del q, k, v
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


# ---------------------------------------------------------- LM training ---

def check_attn_bwd_case(q, k, v, kvl, causal, gen) -> tuple[dict, dict]:
    """The lse forward and both backward kernels vs their plain versions at
    one case: (max-relative errors, fp32 max-abs errors) by output.  The
    lse launch must keep the serving launch's o, dead rows and keys must
    get exactly 0, each kernel run twice the same bits, and dQ under every
    plan (fa.BWD_PLANS: 16- and 64-row blocks, so two grids in two
    orders) the path plan's bits."""
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
    for plan in fa.BWD_PLANS:
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
         path_plan=list(fa.bwd_plan_for(b, s, cfg.n_heads, cfg.n_kv_heads)),
         plans_bitwise=[list(p) for p in fa.BWD_PLANS])
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
    respect to every parameter, by flat name."""
    leaves = {k: p.detach().requires_grad_()
              for k, p in flatten(params).items()}
    loss = tfm.loss_fn(engine, cfg, unflatten_like(leaves, params), batch,
                       remat=True, ce_chunk=min(512, batch["tokens"].shape[1]))
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))


def lm_train_launches(cfg, m: int) -> dict:
    """Exact kernel launches of one LM train step at M = batch x seq rows:
    every GEMM's residual forward twice (the layer's and the CE chunk's
    recompute in the backward), one dX and one dW each, the reduce passes
    their plans split, and per layer two lse forwards, one dQ and one dK /
    dV."""
    want = {**dict.fromkeys(all_launches(), 0),
            "flash_attention_lse": 2 * cfg.n_layers,
            "flash_attention_bwd_dq": cfg.n_layers,
            "flash_attention_bwd_dkv": cfg.n_layers}
    for g in lm_gemms(cfg):
        k, n, reps = g["k"], g["n"], g["per_dispatch"]
        dx = ops.default_bwd_tiles("dx", m, n, k)
        dw = (ops.default_bwd_tiles("dw", n, m, k) if g["trans"]
              else ops.default_bwd_tiles("dw", k, m, n))
        want["gemm_fused_fwd_res"] += 2 * reps
        want["gemm_fwd_regime_b"] += 2 * reps  # every row count is > 64
        want["gemm_bwd_dx"] += reps
        want["gemm_bwd_dw"] += reps
        want["gemm_bwd_reduce"] += reps * ((dx[3] > 1) + (dw[3] > 1))
    return want


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
    want = lm_train_launches(cfg, b * s)
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


def attn_train_rows(cfg, cgen, peak_flops, peak_bw) -> dict:
    """The lse forward and the dQ and dK / dV kernels at the training
    shape: kernel, plain, bound and library ms (CUDA-graph replays;
    library: SDPA's forward and its autograd backward by CUDA events, each
    the faster of the boolean mask with enable_gqa and is_causal on
    repeated K / V, `time_attention.sdpa_fwd_ms` / `sdpa_bwd_ms`, which
    time the repeat, and the group sum of the backward, with it); the lse
    forward and dQ also under every plan (`plans_ms`)."""
    b, s = LM_TRAIN["batch"], LM_TRAIN["seq"]
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = qkv(b, s, s, h, kv, d, torch.float32, cgen)
    do = torch.randn(q.shape, generator=cgen, device=q.device)
    o, lse = fa.flash_attention_fwd(q, k, v, None, return_lse=True)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta, None)
    pairs = float(live_mask(q, k, None, True).sum()) * h
    f4 = 4.0 * q.numel() + 2.0 * 4.0 * k.numel()       # q, k, v once
    rowb = 2 * 4.0 * b * h * s                         # lse and delta
    work = {"flash_attention_lse": (4 * d * pairs, f4 + 4.0 * q.numel()
                                    + 4.0 * b * h * s),
            "flash_attention_bwd_dq": (6 * d * pairs, f4 + 8.0 * q.numel()
                                       + rowb),
            "flash_attention_bwd_dkv": (8 * d * pairs, f4 + 4.0 * q.numel()
                                        + rowb + 8.0 * k.numel())}
    sdpa_bwd = time_attention.sdpa_bwd_ms(q, k, v, do,
                                          live_mask(q, k, None, True))
    sdpa_fwd = time_attention.sdpa_fwd_ms(q, k, v,
                                          live_mask(q, k, None, True), True)
    fns = {"flash_attention_lse": (
               lambda: fa.flash_attention_fwd(q, k, v, None, return_lse=True),
               lambda: fa.flash_attention_plain(q, k, v, None,
                                                return_lse=True),
               sdpa_fwd["library"]),
           "flash_attention_bwd_dq": (
               lambda: fa.flash_attention_bwd_dq(*bwd),
               lambda: fa.flash_attention_bwd_dq_plain(*bwd),
               sdpa_bwd["library"]),
           "flash_attention_bwd_dkv": (
               lambda: fa.flash_attention_bwd_dkv(*bwd),
               lambda: fa.flash_attention_bwd_dkv_plain(*bwd),
               sdpa_bwd["library"])}

    def whole_bwd():
        dl = (do * o).sum(-1).transpose(1, 2).contiguous()
        fa.flash_attention_bwd_dq(q, k, v, do, lse, dl)
        fa.flash_attention_bwd_dkv(q, k, v, do, lse, dl)

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
            rows[name].update(op_ms=op_ms, sdpa_mask_ms=sdpa_bwd["mask"],
                              sdpa_causal_ms=sdpa_bwd["causal"])
    rows["flash_attention_lse"].update(
        sdpa_mask_ms=sdpa_fwd["mask"], sdpa_causal_ms=sdpa_fwd["causal"],
        plan=list(fa.plan_for(b, s, h, kv)),
        plans_ms={str(tuple(p)): graph_ms(
            lambda p=p: fa.flash_attention_fwd(q, k, v, None,
                                               return_lse=True, plan=p))
            for p in fa.PLANS})
    rows["flash_attention_bwd_dq"].update(
        plan=list(fa.bwd_plan_for(b, s, h, kv)),
        plans_ms={str(tuple(p)): graph_ms(
            lambda p=p: fa.flash_attention_bwd_dq(*bwd, plan=p))
            for p in fa.BWD_PLANS})
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


def timing_lm_train_phase(cfg, dev, cgen, peak_flops, peak_bw, smi,
                          launches: dict) -> dict:
    """Phase timing_lm_train (see the module docstring); `launches` are
    phase lm_train's counts over its LM_TRAIN["steps"] steps."""
    seed, b, s = LM_TRAIN["seed"], LM_TRAIN["batch"], LM_TRAIN["seq"]
    ocfg = opt.AdamWConfig(warmup_steps=1, decay_steps=LM_TRAIN["steps"])
    batch = lm_train_batch(cfg, dev, 0, b, s, seed)
    steps = {}
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
        if label == "cuda":
            by_kernel = time_ssd.device_time_by_kernel(
                lambda: step(params, state, batch))
        del params, state, step
        torch.cuda.empty_cache()
    device_ms = sum(r["ms"] for r in by_kernel.values())
    emit("timing_lm_train_step", smi=smi, arch=LM_ARCH, batch=b, seq=s,
         steps=steps, device_ms=device_ms,
         device_busy_share=device_ms / steps["cuda"]["ms"],
         top_kernels=dict(list(by_kernel.items())[:20]))
    rows = attn_train_rows(cfg, cgen, peak_flops, peak_bw)
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
        b, s, h, p, g, n, chunk = case
        for dtype, kind in ((torch.float32, "fp32"), (torch.bfloat16,
                                                      "bf16")):
            for init in (False, True):
                x, dt, a, bm, cm, st = ssd_operands(b, s, h, p, g, n, dtype,
                                                    cgen, init)
                got = ops.ssd(x, dt, a, bm, cm, chunk=chunk, init_state=st)
                again = ops.ssd(x, dt, a, bm, cm, chunk=chunk,
                                init_state=st)
                want = ssd.ssd_scan_plain(x, dt, (dt * a).contiguous(), bm,
                                          cm, chunk=chunk, init_state=st)
                torch.cuda.synchronize()
                where = f"{case} {kind} init={init}"
                check(all(bool(torch.isfinite(t).all()) for t in got),
                      f"non-finite SSD output at {where}")
                err = max(relmax(got[0], want[0]), relmax(got[1], want[1]))
                check(err <= (FP32_TOL if kind == "fp32" else BF16_TOL),
                      f"SSD kernel vs plain {err:.3e} at {where}")
                check(torch.equal(got[0], again[0])
                      and torch.equal(got[1], again[1]),
                      f"two SSD runs differ at {where}")
                da = (dt * a).contiguous()
                for plan in ssd.PLANS:
                    other = ssd.ssd_scan(x, dt, da, bm, cm, chunk=chunk,
                                         init_state=st, plan=plan)
                    check(torch.equal(other[0], got[0])
                          and torch.equal(other[1], got[1]),
                          f"SSD plan {plan} differs from the path plan's "
                          f"bits at {where}")
                    bits += 2
                worst[kind] = max(worst[kind], err)
                which = ("prefill" if case == prefill else
                         "serve" if case in serve else None)
                if which and kind == "fp32":
                    path_abs[which] = max(path_abs[which], *(float(
                        (g.double() - w.double()).abs().max())
                        for g, w in zip(got, want)))
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
            out[label] = make_prefill_step(engine, cfg)(params, tokens)
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
            h = tfm.forward_hidden(eager, cfg, params, tokens=torch.tensor(
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
                _, caches = prefill(params, tokens)
                tok = tokens[:, -1:]
                pre = host_ms(lambda: prefill(params, tokens), reps=3)
                dec = host_ms(lambda: decode(params, caches, tok, s))
                steps[f"{label}_b{b}"] = {
                    "prefill_ms": pre, "prefill_tokens_per_s": b * s / pre
                    * 1e3, "decode_step_ms": dec,
                    "decode_ms_per_token": dec / b}
                if label == "cuda" and b == SSM_PREFILL[0]:
                    decode_kernels = time_ssd.device_time_by_kernel(
                        lambda: decode(params, caches, tok, s))
                    regimes = {
                        "prefill": regime_counts(lambda: prefill(params,
                                                                 tokens)),
                        "decode": regime_counts(lambda: decode(
                            params, caches, tok, s))}
                del caches
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, SSM_PREFILL)).to(dev)
        prefill = make_prefill_step(cuda, cfg)
        by_kernel = time_ssd.device_time_by_kernel(lambda: prefill(params, tokens))
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
    return (ops.default_tiles(m, k, n), ops.bwd_plan("dx", m, n, k, b),
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
    regime = f"gemm_fwd_regime_{ops.default_tiles(m, k, n).regime.lower()}"
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
    path's plan: kernel, plain, torch.bmm (TF32 off, a baseline only) and
    bound ms (2 B M K N FFMA-rate operations; each operand read once, the
    output written once)."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off")
    b, m, k, n = EXPERT_BMM[0]
    dev = gen.device
    x = torch.randn(b, m, k, generator=gen, device=dev)
    w = torch.randn(b, k, n, generator=gen, device=dev) / math.sqrt(k)
    dy = torch.randn(b, m, n, generator=gen, device=dev)
    plan, (dxt, dxs), (dwt, dws) = bmm_plans(b, m, k, n)
    nbytes = 4.0 * (b * m * k + b * k * n + b * m * n)
    flops = 2.0 * b * m * k * n
    rows = {}
    for name, fn, plain, library in (
            ("bmm_fwd", lambda: gemm.bmm_fwd(x, w, plan=plan),
             lambda: gemm.bmm_fwd_plain(x, w), lambda: torch.bmm(x, w)),
            ("bmm_bwd_dx",
             lambda: gemm.bmm_bwd_dx(dy, w, plan=dxt, splits=dxs),
             lambda: gemm.bmm_bwd_dx_plain(dy, w),
             lambda: torch.bmm(dy, w.transpose(1, 2))),
            ("bmm_bwd_dw",
             lambda: gemm.bmm_bwd_dw(x, dy, plan=dwt, splits=dws),
             lambda: gemm.bmm_bwd_dw_plain(x, dy),
             lambda: torch.bmm(x.transpose(1, 2), dy))):
        ms = cuda_ms(fn, reps=5, repeats=3)
        plain_ms = cuda_ms(plain, reps=5, repeats=3)
        library_ms = cuda_ms(library, reps=5, repeats=3)
        bound_ms, bound_by = bound(flops, nbytes, peak_flops, peak_bw)
        rows[name] = row = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ops_ms": flops / peak_flops * 1e3,
            "bytes_ms": nbytes / peak_bw * 1e3,
            "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms}
        emit("timing_bmm", kernel=name, smi=smi, shape=[b, m, k, n],
             plans={"forward": list(plan), "dx": [dxt, dxs],
                    "dw": [dwt, dws]},
             **row)
    return rows


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
            out, _ = make_prefill_step(engine, cfg)(params, tokens)
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

    # --------------------------------------------------- 16-19. LM training
    bwd_abs = attn_bwd_phase(cgen)
    tl = lm_train_phase(cfg, dev)
    lm_restart_phase(dev)
    train_rows = timing_lm_train_phase(cfg, dev, cgen, peak_flops, peak_bw,
                                       smi, tl)
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

    # ------------------------------------ 24-28. the bmm op, the direct conv
    bmm_abs = check_bmm_phase(cgen)
    eb = engine_bmm_phase(dev)
    bmm_rows = timing_bmm_phase(cgen, peak_flops, peak_bw, smi)
    figure3_phase(cgen, peak_flops, peak_bw, smi)
    torch.cuda.empty_cache()
    conv = conv_direct_phase(net, cgen, peak_flops, peak_bw, smi)

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
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
