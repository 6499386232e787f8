#!/usr/bin/env python3
"""On-card smoke test of flexflow_tpu_torch, the PyTorch + CUDA port.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports torch, numpy and the port only, and fails (non-zero exit, no
result line) on any failed phase:

  1. build   — compiles every kernel source of csrc/ (five) with nvcc
               for sm_90a, all at once, and prints each build's time and
               ptxas report;
  2. kernels — after a 2 s warm-up that brings the card to its working
               clock, each decode kernel against its plain PyTorch
               version at the serving path's shapes (8 sequences x 16
               heads x 64, max_len 512, 16-row pages, 256 pages): #4 and
               #5 at w = 1 and 5 (atol 1e-4), #6 on int8 pools with a
               scale-0 page at w = 1 and 5, #7-#9 under a seeded random
               draft tree at w = 13 and #7, #8 also at w = 64 (atol
               1e-5), with times, bounds, a library yardstick where
               PyTorch has one and the card's clocks and power, and for
               every timed kernel (#4, #5 and #6 also at w = 5), its
               plain version and the library call the profiler's device
               time and the host time of one call; the six at bf16 q (a
               mixed-precision model's projections; #4, #5 and #6 at w = 1
               and 5, #7-#9 at w = 13 and 64) against their plain versions
               within one bf16 ulp of the output's largest entry, timed at
               their path's width beside bf16 SDPA where PyTorch has one
               and beside their own device time at fp32 q; then all six
               (on the split-KV body of tree_kernel.cu at head_dim <= 256,
               on decode_kernel.cu's past it), at fp32 and bf16 q, at the
               edges of their card tests: widths 1-64, head_dim 16, 24
               (int8 rows in 8-byte loads), 128, 256 and 320 (w = 64
               included), a ragged max_len at 2-row pages, lengths 0 and
               max_len - w, holes, scale-0 pages, dead rows exactly 0,
               repeat calls bit-identical;
  3. serve   — the flagship decoder LM (12 layers, hidden 1024, 16
               heads, ff 4096, vocab 32000, seeded random weights) serves
               32 requests on 8 slots x 512 tokens under the default
               paged ServeConfig; every request must finish and the paged
               kernel must run once per layer per decode step; a profiled
               window of 16 decode steps with #5's device time per call;
  4. checks  — at 2 layers and full width: the slot and paged layouts
               give token-identical greedy streams (the slot layout runs
               the contiguous kernel), and cached decode logits match a
               full no-cache forward within 1e-3;
  4b. spec   — speculative decoding and int8 pools: the flagship LM
               serves 8 long requests (bench_serve._long_requests: 1-4
               token prompts, 496 new tokens) plain on fp32 pools (a),
               with token-tree speculation (n-gram drafts, spec_k 4,
               spec_branch 3, w = 13) on fp32 pools (b, kernel #8),
               plain on int8 pools (c, #6) and tree spec on int8 pools
               (d, #9); at 2 layers, tree spec on the slot layout (e, #7)
               and linear spec on int8 pools (f, #6 at w = 5), each beside
               a plain run. Every request finishes, each leg's kernel
               runs steps x layers times, and each greedy spec stream
               equals its plain leg's but where it first differs at a
               near-tie of the plain run's top two logits (<= 1e-4 on
               fp32 pools, <= 1e-2 on int8 pools, whose round trip
               turns GEMM noise into int8 steps), and the spec run's
               logit gaps stay that close to the plain run's before any
               divergence; tokens/s, verify steps, acceptance, accepted
               tokens per verify and KV pool bytes, and a profiled
               window of (a)'s, (b)'s, (c)'s and (d)'s steps and of the
               plain slot run's (#4) with the leg's kernel's device time
               per launch beside the step's GEMMs, (a)'s, (c)'s and the
               slot run's also at ~250-token contexts;
  4c. multistep — device-resident multi-step decode: the flagship burst
               of phase 3 again with decode_multistep=True (streams equal
               to phase 3's), then 8 long requests eager and as CUDA-graph
               windows of up to 8 steps on (a) 12 layers, fp32 pools (#5),
               (b) 12 layers, int8 pools (#6) and (c) 2 layers, the slot
               layout (#4): every request finishes, each run's kernel
               launches decode steps x layers times (replays counted),
               the graph streams equal the eager ones token for token and
               one graph serves each run; tokens/s, ms per decode step,
               windows, host syncs per token and a profiled window's
               device ms against wall ms per step on [multistep] lines;
  4d. mixed-precision serving — the flagship LM compiled with
               allow_mixed_precision from phase 3's seeded weights: (a)
               phase 3's burst on fp32 paged pools, (b) the 8 long
               requests plain and with tree spec on fp32 pools (#5, #8)
               and on int8 pools (#6, #9), (d) (b)'s plain leg as
               decode_multistep graph windows, and at 2 layers (c) plain
               and tree spec on the slot layout (#4, #7); every request
               finishes, each leg's bf16-q kernel launches steps x layers
               times (replays counted) and no fp32-q one, (d)'s streams
               equal (b)'s eager plain ones, spec streams equal their
               plain leg's but at a near-tie within NEAR_TIE_BF16_ULPS
               (int8: NEAR_TIE_BF16_ULPS_INT8) bf16 ulps of the logit,
               cached decode logits match the full no-cache mixed forward
               within CACHE_ULPS_BF16 ulps; each leg's tokens/s, step ms,
               TTFT, acceptance and KV pool bytes beside its fp32 run of
               this call ([mixed] lines), and profiled windows of (a) and
               (d) with the bf16-q kernel, the GEMMs and the casts per
               step beside the device time of casting the weights alone;
  4e. features — the serving features of real traffic on the fp32
               flagship (12 layers), one [features] JSON line a leg:
               #4, #5 and #6 against their plain versions at chunk widths
               (w = 16 and 64, staircase offsets) with times and bounds;
               (a) sampling: phase 3's burst at T = 0.8, seed 1234, twice
               (identical streams), with decode_multistep (streams equal
               eager) and a linear n-gram spec leg at T = 0.8 (all
               FINISHED, acceptance printed); the sampler's bits and
               tokens on the card equal the CPU's for fixed (seed, slot,
               position, logits); (b) chunked prefill: 16 prompts of
               96-448 tokens (32 new) interleaved with 16 of 1-6 tokens
               (64 new) at token_budget 128, chunk_size 16 beside the
               monolithic run, on fp32 pools (#5), int8 pools (#6) and the
               slot layout (#4): greedy streams equal or first part at a
               near-tie (NEAR_TIE; int8 NEAR_TIE_INT8), the leg's kernel
               launched (decode steps + chunk steps) x layers times, the
               short requests' TTFT p50/p95 beside the monolithic run's;
               (c) prefix cache: 24 requests behind a 256-token system
               prompt (16 pages) with 8-40 tokens of their own, the
               first arriving an iteration ahead, shared against
               unshared, fp32 and int8 pools: streams as (b),
               pages shared > 0, invariants hold, prefill tokens skipped
               and TTFT; (d) optimistic admission on (b)'s requests,
               the 16 long ones first, with kv_pages 128 (half the
               default pool) against reserve on the same pool: preemptions
               > 0, every request FINISHED, streams as (b);
  4f. async — the double-buffered loop (serve_async=True) beside the
               sync one, on fresh schedulers in one process, one [async]
               JSON line a leg (tokens/s of each run, wall ms a step,
               TTFT p50 / p95, overlap fraction, mean dispatch gap, host
               syncs per token, drains, pre-proposal hits and misses,
               evictions): first a chained decode, a multi-step window, a
               verify and a chunk dispatch of the 12-layer flagship under
               torch.cuda.set_sync_debug_mode("error") (none may wait for
               the stream); then at 12 layers (a) phase 3's burst (#5;
               runs in turns sync, async, async, sync; a profiled window
               of each loop, device ms against wall ms), (b) (a) at T =
               0.8, seed 1234, (c) 4e (b)'s traffic chunked (token_budget
               128, chunk_size 16) on int8 pools under optimistic
               admission at kv_pages 72 (#6; preemptions > 0), and at 2
               layers (d) the 8 long requests with linear n-gram spec
               (spec_k 4; #5 at w = 5) and with tree spec on int8 pools
               (#9), (e) them with decode_multistep (graph windows through
               the in-flight deque; profiled windows), (f) them on the slot
               layout, plain (#4) and tree spec (#7), (g) 4e (c)'s
               shared-prompt traffic with prefix_evict="lru" on 48 pages
               (evictions > 0) beside prefix_evict="none". Every request
               FINISHED, each run's kernel launched (decode + verify +
               chunk dispatches) x layers times (replays counted); the
               async streams equal the sync ones in (a), (b), (e) and plain
               (f), elsewhere they may part only at a near-tie of the sync
               run's top two logits (NEAR_TIE, int8 NEAR_TIE_INT8);
  4g. tenancy and model draft — multi-tenant serving and the small-model
               draft on the fp32 flagship (12 layers), one [tenancy] JSON
               line a leg: (a) phase 3's burst with no pool, then with a
               pool of two loaded adapters (rank 8, seeds 0 and 1) and
               every request on the base model, eager, with
               decode_multistep and with serve_async: streams equal
               phase 3's; profiled decode steps with and without the pool
               (eager and as graph windows: wall and device ms a step,
               device ops added); (b) the burst with adapters rotating 0 /
               1 / none: each adapter's streams equal those of the burst
               run with every request on that adapter, the base ones
               phase 3's, and each adapter moves the first logits of a
               prompt by more than 1e-3; (c) 32 requests of 4 + U[0, 128)
               prompt tokens and 64 new, gold / bronze alternating,
               adapters rotating, at token_budget 128, chunk_size 16 with
               classes "gold:4,bronze:1" beside no classes: streams equal
               up to a near-tie, every bronze request finishes, gold's
               mean admit iteration below bronze's, TTFT p50 / p95 by
               class; the same on int8 pools under optimistic admission
               at TENANT_PAGES pages beside reserve: preemptions > 0, the
               victims' classes printed; (d) spec_draft="model": the
               flagship as its own draft on fp32 pools (acceptance 1.0
               but at near-ties of the verify logits, streams phase 3's),
               a seeded 2-layer draft at full width with spec_k 4, linear
               on fp32 pools (#5 at w = 5), tree (spec_branch 3) on int8
               pools (#9) beside a plain int8 run and linear under
               serve_async (streams the sync run's, or phase 3's up to a
               near-tie). Every request FINISHED, each leg's target
               kernel launched (decode + verify + chunk steps) x layers
               times (replays counted) and the draft's #4 draft steps x 2;
               the phase's time is printed;
  5. flash kernels — #1-#3 against their plain versions at the flagship
               training shape (q, k, v [8, 512, 16, 64]), causal and
               not, ragged (sq 500, sq != sk, head_dim 24, 128, and
               past 128 on the wide bodies, which compute the scores once
               per tile pair and stream the loop operand over head_dim:
               160, 256, 264, 320, 512 and 1032; #1's also at its edges:
               136, 248, one visible key, sq 32 and 33, the widest
               resident Q at 1216 and streamed at 1224)
               and at the reference's test shapes
               (tests/test_flash_kernel.py, head_dim 32, the uneven 128 x
               384 included), at the reference's scale: O and LSE within
               2e-5, dQ, dK, dV within atol 5e-5 and rtol 5e-4; with
               times (the event timer's and the profiler's device time per
               call), bounds, the library call (SDPA forward beside #1,
               SDPA backward for the #2 + #3 pair, with the device kernel
               each runs), the port's dense core, also timed, gated there
               too, on the wide bodies at [8, 512, 4, 320] (the rows of
               the kernels line, counted under name + "_wide"; causal
               too), [8, 512, 4, 256] and [8, 256, 2, 512]; each kernel's
               registers, spills, shared memory and blocks per SM at
               head_dim 64, 128, 136, 256, 264, 320, 512 and 1032 (past 256
               also the backward's wide kernels for bf16), the count of
               tensor-core (HMMA) instructions in each flash library's
               SASS, and the card's clocks and power; the fp32 wide
               kernels also on a training path (2 layers of 2 heads of
               320, 3 steps of fit());
  5b. bf16 flash kernels — the bf16 bodies of #1-#3 (mixed precision)
               and their plain versions, both held against the float64
               function of the same bf16 inputs (the kernel's error at
               most twice the plain version's plus one bf16 ulp of the
               exact output's largest entry; LSE within 2e-5) at the
               flagship shape, causal and not, ragged (sq 500, sq !=
               sk), head_dim 24-256, past 256 on the wide bodies for bf16
               (264, 320, 512, 1032; #1's bf16 mma.sync body with its Q
               tile resident, and at 2056 with Q streamed beside K; #2 and
               #3 on the backward file's wide kernels for bf16) and the
               reference's test shapes; times at the flagship shape and
               at [8, 512, 8, 128] and [8, 512, 4, 256] beside bf16 SDPA
               with its backend, and of the bf16 wide kernels at [8, 512,
               4, 320] (#1 causal too) and [8, 256, 2, 512], bounds at 989
               TFLOP/s, resources at head_dim 64, 128 and 256 (#1-#3 up
               to 256 are the wgmma bodies, which ptxas must not
               serialize; #2 and #3 also where one key is visible), of
               #1's wide body at 320, 512 and 1032, and the bf16 library's
               HMMA and HGMMA (wgmma) counts, HGMMA required; the bf16
               wide kernels also on a training path (2 layers of 2
               heads of 320 under mixed precision, 3 steps of fit());
  6. train   — the flagship Transformer (examples/transformer.py: 12 x
               [MHA(1024, 16 heads) -> dense+ReLU -> dense] -> dense(1),
               batch 8, seq 512, fp32, SGD lr 0.01, MSE) trains through
               fit() for 10 iterations of seeded randn data; each flash
               kernel must run 12 times per step and the loss stay
               finite; samples/s, step ms, peak memory and a profiled
               step's device busy share and top device ops;
  6b. mixed precision — the same flagship compiled with
               allow_mixed_precision (bench.py's mode) trains through
               fit() for 10 iterations: each bf16 flash kernel runs 12
               times per step and no fp32 one; samples/s, step ms, peak
               memory and a profiled step beside phase 6's; then from
               the same weights and batch 10 steps of each, the two loss
               curves held at the last step by the reference's
               criterion (tests/test_precision.py: |bf16 - fp32| <
               0.25 |fp32| + 0.05);
  7. training checks — from the same weights and batch, the flash kernels
               and the dense core give each weight's gradient within 1e-3
               of its largest entry, and one step of each agrees (loss
               1e-5 relative, weights 1e-5 absolute, printed beside the
               step's own size; peak memory of both); the
               loss falls over 10 steps on one batch; and the causal
               decoder LM at full width (2 layers, tokens [8, 512],
               sparse CE, SGD lr 0.01) trains through fit() for 4
               iterations with each flash kernel run 2 times per step,
               in fp32 and again under mixed precision (the bf16 ones);

then prints the kernels' JSON line (launches: the serving path's for
#4 and #5, legs (c), (e), (b) and (d) for #6-#9, phase 4d's legs for
their bf16-q paths, the flagship training run's for #1-#3, the
mixed-precision run's for their bf16 bodies and the head_dim-320 runs'
for the fp32 and the bf16 wide kernels), the card's name and
power limit, and as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
ATOL_KERNEL = 1e-4  # fp32 kernel vs plain version: summation order only
# kernels #6-#9 vs plain versions: the staged int8 rows are dequantized
# exactly as the plain version does, so only summation order differs
ATOL_SPEC_KERNEL = 1e-5
# a spec stream may first differ from its plain leg only where the plain
# run's top two logits lie this close: a near-tie that two cuBLAS GEMM
# shapes (8 decode rows against 8 x w verify rows) may order either way
NEAR_TIE = 1e-4
# the same on int8 pools. There the GEMM noise now and then moves a K/V
# element across a rounding boundary (one int8 step is 1/127 of its row's
# range), and a tree commit re-quantizes every moved row under its new
# page's scale, as the reference's _compact_rows does; the two runs'
# logits drift apart by up to ~2e-3 before any divergence, where the fp32
# legs stay under 1e-5. A wrong kernel moves them by O(0.1).
NEAR_TIE_INT8 = 1e-2
ATOL_LOGITS = 1e-3  # cached decode vs full forward through 12 fp32 layers
# Under allow_mixed_precision (phase 4d) the limits are counted in bf16
# ulps of the logit they concern (bf16_ulp of the token's largest logit):
# each layer rounds its activations and GEMM outputs to bf16, so two GEMM
# shapes (8 decode rows against 8 x w verify rows) that sum in another
# order give logits a few bf16 ulps apart, where fp32 ones stay within
# 1e-5; on int8 pools a one-ulp difference in a K/V element moves it
# across an int8 rounding boundary more often still
NEAR_TIE_BF16_ULPS = 8
NEAR_TIE_BF16_ULPS_INT8 = 32
# cached decode logits against the full no-cache mixed forward: the full
# forward's dense core rounds P to bf16 (the reference's
# ops/attention.py:213), where the decode kernels keep it f32
CACHE_ULPS_BF16 = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # H100 SXM, bf16 tensor cores, dense
FP32_FLOPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
# H100 SXM, TF32 tensor cores, dense; fp32-accurate products take 3 passes
TF32_FLOPS_PER_S = 495e12
TF32_PASSES = 3

# flash kernels #1-#3 vs plain versions, at the reference's own scale
# (tests/test_flash_kernel.py): O and LSE within 2e-5, taken as absolute;
# dQ, dK, dV within atol 5e-5 and rtol 5e-4
ATOL_FLASH_FWD = 2e-5
ATOL_FLASH_GRAD, RTOL_FLASH_GRAD = 5e-5, 5e-4
RTOL_STEP_LOSS = ATOL_STEP_WEIGHTS = 1e-5  # flash vs dense core, one step
# flash vs dense core, each weight's gradient against its own largest
# entry: summation order gives ~1e-6..1e-5 through 12 fp32 layers, a wrong
# backward (mask, scale, delta) gives O(1)
RTOL_GRAD_FLASH_DENSE = 1e-3
# a gradient that is 0 in exact arithmetic (the key bias: softmax ignores
# a constant added to a row) is held against this share of the model's
# largest gradient instead of its own rounding noise
GRAD_FLOOR = 1e-4

FLAGSHIP = dict(layers=12, hidden=1024, heads=16, vocab=32000, max_seqs=8, max_len=512)
NUM_REQUESTS = 32
# the speculative-decoding legs: bench_serve._long_requests(32000, 512, 8)
SPEC_REQUESTS = 8
TREE = dict(spec_draft="ngram", spec_k=4, spec_branch=3)  # w = 13
LINEAR = dict(spec_draft="ngram", spec_k=4)  # w = 5
# decode steps before the long-context profiled windows open: the
# contexts then sit near the middle of max_len, as the legs' do on average
LONG_WINDOW_SKIP = 240
# the deepest fused decode window of the multistep phase
MULTISTEP_STEPS = 8
# the flagship Transformer of examples/transformer.py and its training run
TRAIN = dict(layers=12, hidden=1024, heads=16, batch=8, seq=512, steps=10)
LM_TRAIN = dict(layers=2, steps=4)

# kernel wrapper -> (source, the TPU kernel it replaces)
KERNELS = {
    "flash_verify": ("tree_kernel.cu", "flexflow_tpu/ops/pallas/decode_kernel.py:235"),
    "paged_flash_verify": ("tree_kernel.cu", "flexflow_tpu/ops/pallas/decode_kernel.py:342"),
    "paged_flash_verify_quant": ("tree_kernel.cu", "flexflow_tpu/ops/pallas/decode_kernel.py:476"),
    "flash_verify_tree": ("tree_kernel.cu", "flexflow_tpu/ops/pallas/decode_kernel.py:626"),
    "paged_flash_verify_tree": ("tree_kernel.cu", "flexflow_tpu/ops/pallas/decode_kernel.py:732"),
    "paged_flash_verify_tree_quant": ("tree_kernel.cu", "flexflow_tpu/ops/pallas/decode_kernel.py:849"),
    "flash_fwd": ("flash_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:129"),
    "flash_dq": ("flash_bwd_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:230"),
    "flash_dkv": ("flash_bwd_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:269"),
    # fp32 #1-#3 past head_dim 128: the wide bodies of the same files (#1:
    # one body, the scores once per tile pair, Q resident, a TMA ring)
    "flash_fwd_wide": ("flash_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:129"),
    "flash_dq_wide": ("flash_bwd_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:230"),
    "flash_dkv_wide": ("flash_bwd_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:269"),
    "flash_fwd_bf16": ("flash_bf16_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:129"),
    "flash_dq_bf16": ("flash_bf16_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:230"),
    "flash_dkv_bf16": ("flash_bf16_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:269"),
    # bf16 #1-#3 past head_dim 256: #1 on the bf16 file's wide wgmma body
    # (the scores once per tile pair in output chunks of up to 256
    # columns, a TMA ring of 64-column boxes), #2 and #3 on the backward
    # file's wide kernels for bf16
    "flash_fwd_wide_bf16": ("flash_bf16_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:129"),
    "flash_dq_wide_bf16": ("flash_bwd_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:230"),
    "flash_dkv_wide_bf16": ("flash_bwd_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:269"),
}
DECODE = ("flash_verify", "paged_flash_verify", "paged_flash_verify_quant", "flash_verify_tree",
          "paged_flash_verify_tree", "paged_flash_verify_tree_quant")
# the decode kernels at bf16 q (a mixed-precision model), the same sources
KERNELS.update({name + "_bf16": KERNELS[name] for name in DECODE})
FLASH_FP32 = ("flash_fwd", "flash_dq", "flash_dkv")
FLASH_WIDE_FP32 = ("flash_fwd_wide", "flash_dq_wide", "flash_dkv_wide")
FLASH_BF16 = ("flash_fwd_bf16", "flash_dq_bf16", "flash_dkv_bf16")
FLASH_WIDE_BF16 = ("flash_fwd_wide_bf16", "flash_dq_wide_bf16", "flash_dkv_wide_bf16")

# kernel wrapper -> substrings of the device functions its launches run,
# as the profiler names them: each kernel's own instantiations, so that
# no kernel's time counts under another's (#4-#9 run on the split body of
# tree_kernel.cu, and on decode_kernel.cu's past head_dim 256; both are
# templated first on q's element type, float or __nv_bfloat16)
_DECODE_SYMBOLS = {
    "flash_verify": (
        "single_query_kernel<{q}, false,",
        "tree_attention_kernel<{q}, false, false, true,",
        "decode_attention_kernel<{q}, false, false, false>",
    ),
    "paged_flash_verify": (
        "single_query_kernel<{q}, true,",
        "tree_attention_kernel<{q}, true, false, true,",
        "decode_attention_kernel<{q}, true, false, false>",
    ),
    "paged_flash_verify_quant": (
        "single_query_int8_kernel<{q},",
        "tree_attention_kernel<{q}, true, true, true,",
        "decode_attention_kernel<{q}, true, true, false>",
    ),
    "flash_verify_tree": ("tree_attention_kernel<{q}, false, false, false,",
                          "decode_attention_kernel<{q}, false, false, true>"),
    "paged_flash_verify_tree": ("tree_attention_kernel<{q}, true, false, false,",
                                "decode_attention_kernel<{q}, true, false, true>"),
    "paged_flash_verify_tree_quant": (
        "tree_attention_kernel<{q}, true, true, false,",
        "decode_attention_kernel<{q}, true, true, true>",
    ),
}
KERNEL_SYMBOLS = {
    **{name: tuple(x.format(q="float") for x in syms) for name, syms in _DECODE_SYMBOLS.items()},
    **{name + "_bf16": tuple(x.format(q="__nv_bfloat16") for x in syms) for name, syms in _DECODE_SYMBOLS.items()},
    "flash_fwd": ("flash_fwd_mma_kernel",),
    "flash_dq": ("flash_dq_tf32_kernel",),
    "flash_dkv": ("flash_dkv_tf32_kernel", "flash_dkv_mma_kernel"),
    "flash_fwd_wide": ("flash_fwd_wide_kernel",),
    "flash_dq_wide": ("flash_dq_wide_kernel<",),
    "flash_dkv_wide": ("flash_dkv_wide_kernel<",),
    "flash_fwd_bf16": ("flash_fwd_bf16_wgmma_kernel",),
    "flash_dq_bf16": ("flash_dq_bf16_wgmma_kernel",),
    "flash_dkv_bf16": ("flash_dkv_bf16_wgmma_kernel",),
    "flash_fwd_wide_bf16": ("flash_fwd_wide_bf16_wgmma_kernel",),
    "flash_dq_wide_bf16": ("flash_dq_wide_bf16_kernel",),
    "flash_dkv_wide_bf16": ("flash_dkv_wide_bf16_kernel",),
}


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# -- 1. build ------------------------------------------------------------------


def build_kernels():
    """Build every kernel source at once (one nvcc each, in threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from flexflow_tpu_torch.ops.cuda import _build
    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    def timed(lib_fn):
        t0 = time.perf_counter()
        lib_fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    builds = {dk.SOURCE: dk._lib, dk.TREE_SOURCE: dk._tree_lib, fk.SOURCE: fk._lib, fk.BWD_SOURCE: fk._bwd_lib,
              fk.BF16_SOURCE: fk._bf16_lib}
    with ThreadPoolExecutor(len(builds)) as pool:
        times = dict(zip(builds, pool.map(timed, builds.values())))
    print(f"[build] {len(times)} sources in {time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for source, build_s in times.items():
        print(f"[build] {source}: {build_s:.2f} s")
        for line in _build.build_logs.get(source, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "Compiling" in line:
                print(f"[build]   {line.strip()}")
    return times


# -- 2. kernels vs plain versions ----------------------------------------------


def kernel_inputs(device, w, b=8, h=16, d=64, max_len=512, page=16, num_pages=256, seed=SEED, lengths=None):
    """Seeded operands at the serving shapes. Lengths include 0 and
    max_len - w (or are `lengths`, b of them, where given: the other
    operands stay as they are); block tables hold each sequence's pages
    in random pool order, sentinels past its length, one row with a
    sentinel hole inside its visible range and one dead row whose pages
    are all sentinels."""
    import torch

    from flexflow_tpu_torch.ops.attention import tree_allowed_mask

    rng = np.random.default_rng(seed + w)
    drawn = rng.integers(0, max_len - w + 1, size=b).astype(np.int32)
    drawn[0], drawn[1] = 0, max_len - w
    lengths = drawn if lengths is None else np.asarray(lengths, dtype=np.int32)
    pages_per_seq = max_len // page
    tables = np.full((b, pages_per_seq), num_pages, dtype=np.int32)
    free = list(rng.permutation(num_pages))
    for i in range(b):
        need = -(-(int(lengths[i]) + w) // page)
        for p in range(need):
            if free:
                tables[i, p] = free.pop()
    tables[2, 0] = num_pages  # a hole inside row 2's visible range
    tables[b - 1, :] = num_pages  # a dead row
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)
    x = dict(
        q=f(b, w, h, d),
        k_cache=f(b, max_len, h, d),
        v_cache=f(b, max_len, h, d),
        k_pool=f(num_pages, page, h, d),
        v_pool=f(num_pages, page, h, d),
        tables=torch.from_numpy(tables).to(device),
        lengths=torch.from_numpy(lengths).to(device),
    )
    # int8 pools with per-(page, head) scales, row 0's first page never
    # written (scale 0), and a seeded random draft tree per row
    i8 = lambda: torch.from_numpy(rng.integers(-127, 128, (num_pages, page, h, d)).astype(np.int8)).to(device)
    x["k8"], x["v8"] = i8(), i8()
    for name in ("k_scale", "v_scale"):
        sc = rng.uniform(0.001, 0.05, (num_pages, h)).astype(np.float32)
        sc[tables[0, 0]] = 0.0
        x[name] = torch.from_numpy(sc).to(device)
    parents = np.full((b, w), -1, dtype=np.int32)
    for j in range(1, w):
        parents[:, j] = rng.integers(0, j, size=b)
    x["allowed"] = tree_allowed_mask(torch.from_numpy(parents).to(device), x["lengths"], w, max_len)
    return x


def visible_masks(x):
    """[b, w, L] masks of the (query, key) pairs each kernel must score,
    and [b, L] masks of the K/V rows it must read, from this run's data."""
    import torch

    b, w = x["q"].shape[:2]
    lengths = x["lengths"].long()
    L = x["k_cache"].shape[1]
    kpos = torch.arange(L, device=lengths.device)
    stair = kpos[None, None, :] <= lengths[:, None, None] + torch.arange(w, device=lengths.device)[None, :, None]
    page = x["k_pool"].shape[1]
    num_pages = x["k_pool"].shape[0]
    on_page = ((x["tables"] >= 0) & (x["tables"] < num_pages)).long().repeat_interleave(page, dim=1).bool()
    paged_pairs = stair & on_page[:, None, :]
    # the tree kernels see the mask under the chunk gate p < lengths + w
    tree = x["allowed"] & (kpos[None, :] < lengths[:, None] + w)[:, None, :]
    paged_tree = tree & on_page[:, None, :]
    return {
        "flash_verify": (stair, stair.any(dim=1)),
        "paged_flash_verify": (paged_pairs, paged_pairs.any(dim=1)),
        "paged_flash_verify_quant": (paged_pairs, paged_pairs.any(dim=1)),
        "flash_verify_tree": (tree, tree.any(dim=1)),
        "paged_flash_verify_tree": (paged_tree, paged_tree.any(dim=1)),
        "paged_flash_verify_tree_quant": (paged_tree, paged_tree.any(dim=1)),
    }


def bound_ms(x, name):
    """Least time for the function on this run's inputs: each input byte
    read once (only the K/V rows some query sees, as int8 on the int8
    pools, with the scales of the pages they lie on, and the mask bytes
    of the positions a tree kernel visits), each output byte written
    once, against the flops of the two products (and of the dequant
    multiplies)."""
    pairs, rows = visible_masks(x)[name]
    b, w, h, d = x["q"].shape
    quant = name.endswith("_quant")
    nrows = int(rows.sum())
    # q in and the output out at q's element size (2 bytes for bf16 q)
    nbytes = 2 * x["q"].element_size() * b * w * h * d + 4 * b + (1 if quant else 4) * 2 * nrows * h * d
    if name.startswith("paged"):
        nbytes += 4 * x["tables"].numel()
    if quant:
        page = x["k_pool"].shape[1]
        pages = x["tables"].long().repeat_interleave(page, dim=1)
        nbytes += 4 * 2 * h * pages[rows].unique().numel()
    if "tree" in name:
        L = x["allowed"].shape[-1]
        nbytes += w * int((x["lengths"].long() + w).clamp(max=L).sum())
    flops = 4.0 * int(pairs.sum()) * h * d + (2.0 * nrows * h * d if quant else 0.0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")



def time_ms(fn, flush, iters=50, warmup=10):
    """Median device time of one call, each preceded by an L2 flush (on
    the serving path every layer reads its own cold pools). The calls
    are queued back to back with events around each and one sync at the
    end, so the card stays busy and clocked up between them."""
    import torch

    for _ in range(warmup):
        flush()
        fn()
    events = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


# a device-side spin (clock cycles, ~0.1 s at 1980 MHz) queued before
# host_ms's calls, longer than the host takes to queue them
HOST_HOLD_CYCLES = 200_000_000


def host_ms(fn, iters=50, warmup=5):
    """Median host time of one call while the card is held busy by a
    spin queued first, so that no call waits on the device: a wrapper's
    checks, allocations and launch. time_ms counts it too where it
    outlasts the L2 flush queued before the call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_HOLD_CYCLES)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * float(np.median(times))


# On the card a profiler session in some process states does not read
# its first kernel (measured: 19 of 20 flushes read once large flash
# cases had run). So each session starts with one flush of its own,
# whose loss costs nothing; a session whose call kernels do not read a
# whole multiple of the calls is taken again, up to this many times.
PROFILE_TRIES = 3


def device_ms(fn, flush, iters=20, top=False):
    """Device time of one call from the profiler: the kernels that `iters`
    calls run, each after an L2 flush, less the flush's own kernels (by
    name, from a session of flushes alone). None where no session read
    whole calls. With `top`, also the name of the kernel that takes most
    of that time (the backend a library call ran)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def session(run):
        """{kernel: (device us, launches)} read by one profiler session."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flush()
            run()
            torch.cuda.synchronize()
        return {
            e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        }

    def flushes():
        for _ in range(iters):
            flush()

    def calls():
        for _ in range(iters):
            flush()
            fn()

    mine = {}
    for _ in range(PROFILE_TRIES):
        alone = session(flushes)
        read = {k: v for k, v in session(calls).items() if k not in alone} if alone else {}
        if read and all(n % iters == 0 for _, n in read.values()):
            mine = {k: t for k, (t, _) in read.items()}
            break
        print("[profile] a profiler session read no or part of the calls; taken again")
    us = sum(mine.values())
    ms = us / 1e3 / iters if us > 0 else None
    if top:
        return ms, max(mine, key=mine.get)[:80] if mine else "not measured"
    return ms


def check_kernels():
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk

    device = torch.device("cuda")
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    flush = lambda: flush_buf.zero_()
    rows = {}
    for w in (1, 5):
        x = kernel_inputs(device, w)
        calls = {
            "flash_verify": (
                lambda: dk.flash_verify(x["q"], x["k_cache"], x["v_cache"], x["lengths"]),
                lambda: dk.flash_verify_ref(x["q"], x["k_cache"], x["v_cache"], x["lengths"]),
            ),
            "paged_flash_verify": (
                lambda: dk.paged_flash_verify(x["q"], x["k_pool"], x["v_pool"], x["tables"], x["lengths"]),
                lambda: dk.paged_flash_verify_ref(x["q"], x["k_pool"], x["v_pool"], x["tables"], x["lengths"]),
            ),
        }
        masks = visible_masks(x)
        for name, (kernel, plain) in calls.items():
            out = kernel()
            torch.cuda.synchronize()
            ref = plain()
            require(bool(torch.isfinite(out).all()), f"{name} w={w}: non-finite output")
            err = float((out - ref).abs().max())
            print(f"[kernels] {name} w={w}: max |kernel - plain| = {err:.3e}")
            require(err <= ATOL_KERNEL, f"{name} w={w}: error {err} > {ATOL_KERNEL}")
            row = rows.setdefault(name, {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            # timings at the decode path's shapes (w = 1), and at w = 5 too
            # (the linear verify), printed only
            if name == "flash_verify":
                kv = (x["k_cache"], x["v_cache"])
            else:
                safe = x["tables"].long().clamp(0, x["k_pool"].shape[0] - 1)
                kv = tuple(p[safe].reshape(x["q"].shape[0], -1, *p.shape[2:]) for p in (x["k_pool"], x["v_pool"]))
            mask = masks[name][0][:, None]  # [b, 1, w, L]
            qt, kt, vt = x["q"].transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2)
            library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            t = dict(ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush), library_ms=time_ms(library, flush))
            t["bound_ms"], t["bound_by"] = bound_ms(x, name)
            if w == 1:  # the kernels line keeps the decode path's width
                row.update(t)
            print(
                f"[kernels] {name} w={w}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms, "
                f"{t['bound_by']}), plain {t['plain_ms']:.4f} ms, "
                f"library sdpa {t['library_ms']:.4f} ms"
            )
            # the event timer counts a call's host side where it outlasts
            # the flush: the profiler's device time and the host time of
            # each call tell the two apart
            print_timing(name, w, t, flush, kernel=kernel, plain=plain, library=library)
    return rows


def print_timing(name, w, t, flush, **fns):
    """One [timing] line: for each of `fns` (kernel, plain, library) the
    event timer's ms from `t`, the profiler's device ms and the host ms
    of one call."""
    split = {
        who: dict(ms=t["ms" if who == "kernel" else who + "_ms"], device_ms=device_ms(fn, flush), host_ms=host_ms(fn))
        for who, fn in fns.items()
    }
    print("[timing] " + json.dumps(dict(name=name, w=w, **split)))


def check_spec_kernels():
    """Kernels #6-#9 against their plain versions at the serving shape
    of check_kernels: #6 at w = 1 and 5, #7-#9 at w = 13 under a seeded
    random draft tree per row, and #7, #8 also at w = 64 (the widest tree
    ServeConfig takes), atol 1e-5. Each is timed at its path's width as
    #4 and #5 are (#6 at w = 1, the int8 decode step; the tree kernels at
    w = 13; #6 again at w = 5, leg (f)'s linear verify, and #7 and #8 at
    w = 64, printed only), with its bound
    and its plain version; #7 and #8 also with masked SDPA under the tree
    mask as the library yardstick (for #8 on K/V gathered from the pages
    before the timer starts, so its number leaves out the gather), and
    for #7, #8, their plain versions and SDPA the profiler's device time
    and the host time of one call beside the timer's. No PyTorch call
    dequantizes int8 inside attention, so #6 and #9 have none."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk

    device = torch.device("cuda")
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    flush = lambda: flush_buf.zero_()
    tree_names = ("flash_verify_tree", "paged_flash_verify_tree", "paged_flash_verify_tree_quant")
    fp32_tree = tree_names[:2]
    path_w = {"paged_flash_verify_quant": 1, **dict.fromkeys(tree_names, 13)}  # the kernels line's width
    timed = {("paged_flash_verify_quant", 1), ("paged_flash_verify_quant", 5), *((n, 13) for n in tree_names),
             *((n, 64) for n in fp32_tree)}
    rows = {}
    cases = ((1, ("paged_flash_verify_quant",)), (5, ("paged_flash_verify_quant",)), (13, tree_names), (64, fp32_tree))
    for w, names in cases:
        x = kernel_inputs(device, w)
        masks = visible_masks(x)
        for name in names:
            kernel = lambda fn=getattr(dk, name), a=decode_args(x, name): fn(*a)
            plain = lambda fn=getattr(dk, name + "_ref"), a=decode_args(x, name): fn(*a)
            out = kernel()
            torch.cuda.synchronize()
            ref = plain()
            require(bool(torch.isfinite(out).all()), f"{name} w={w}: non-finite output")
            err = float((out - ref).abs().max())
            print(f"[kernels] {name} w={w}: max |kernel - plain| = {err:.3e}")
            require(err <= ATOL_SPEC_KERNEL, f"{name} w={w}: error {err} > {ATOL_SPEC_KERNEL}")
            row = rows.setdefault(name, {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if (name, w) not in timed:
                continue
            t = dict(ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush))
            t["bound_ms"], t["bound_by"] = bound_ms(x, name)
            if name.endswith("_quant"):
                t["library_ms"] = None
                library = "none: no PyTorch call dequantizes int8 pages inside attention"
            else:
                if name == "flash_verify_tree":
                    kv = (x["k_cache"], x["v_cache"])
                else:
                    safe = x["tables"].long().clamp(0, x["k_pool"].shape[0] - 1)
                    kv = tuple(p[safe].reshape(x["q"].shape[0], -1, *p.shape[2:]) for p in (x["k_pool"], x["v_pool"]))
                mask = masks[name][0][:, None]  # [b, 1, w, L]
                qt, kt, vt = x["q"].transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2)
                sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
                t["library_ms"] = time_ms(sdpa, flush)
                library = f"masked sdpa {t['library_ms']:.4f} ms"
                if name.startswith("paged"):
                    library += " (on K/V gathered from the pages before the timer starts)"
            if w == path_w[name]:  # the kernels line keeps the path's width
                row.update(t)
            print(
                f"[kernels] {name} w={w}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms, "
                f"{t['bound_by']}), plain {t['plain_ms']:.4f} ms, library {library}"
            )
            # time_ms counts a call's host side where it outlasts the
            # flush: the profiler's device time and the host time of each
            # call tell the two apart
            fns = dict(kernel=kernel, plain=plain) if name.endswith("_quant") else \
                dict(kernel=kernel, plain=plain, library=sdpa)
            print_timing(name, w, t, flush, **fns)
    return rows


def decode_args(x, name):
    """The operands of decode entry point `name` on kernel_inputs x."""
    quant = (x["q"], x["k8"], x["v8"], x["k_scale"], x["v_scale"], x["tables"], x["lengths"])
    return {
        "flash_verify": (x["q"], x["k_cache"], x["v_cache"], x["lengths"]),
        "paged_flash_verify": (x["q"], x["k_pool"], x["v_pool"], x["tables"], x["lengths"]),
        "paged_flash_verify_quant": quant,
        "flash_verify_tree": (x["q"], x["k_cache"], x["v_cache"], x["lengths"], x["allowed"]),
        "paged_flash_verify_tree": (x["q"], x["k_pool"], x["v_pool"], x["tables"], x["lengths"], x["allowed"]),
        "paged_flash_verify_tree_quant": quant + (x["allowed"],),
    }[name]


# the bf16-q widths of phase 2: the decode step and linear verify (w 1, 5)
# and the tree verify (w 13) and the widest tree ServeConfig takes (64);
# the kernels line keeps each one's path width (PATH_W)
BF16_Q_WIDTHS = {"flash_verify": (1, 5), "paged_flash_verify": (1, 5), "paged_flash_verify_quant": (1, 5),
                 "flash_verify_tree": (13, 64), "paged_flash_verify_tree": (13, 64),
                 "paged_flash_verify_tree_quant": (13, 64)}
PATH_W = {"flash_verify": 1, "paged_flash_verify": 1, "paged_flash_verify_quant": 1,
          "flash_verify_tree": 13, "paged_flash_verify_tree": 13, "paged_flash_verify_tree_quant": 13}


def check_bf16_q_kernels():
    """#4-#9 at bf16 q (a mixed-precision model's projections) against
    fp32 and int8 pools at the serving shape of check_kernels, with its
    holes, dead row and scale-0 page, against their plain versions: the
    output bf16 and within one bf16 ulp of its largest entry of the plain
    version (both round the f32 function of the widened q once, and their
    f32 values differ in summation order only). At each kernel's path
    width: the event timer, the bound (q and the output at 2 bytes), the
    plain version, bf16 SDPA for #4, #5 and masked bf16 SDPA for #7, #8
    (K/V cast to bf16, and gathered from the pages, before the timer),
    and the profiler's device time beside the same kernel's at fp32 q."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk

    device = torch.device("cuda")
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    flush = lambda: flush_buf.zero_()
    rows = {}
    for w in (1, 5, 13, 64):
        x = kernel_inputs(device, w)
        xb = dict(x, q=x["q"].bfloat16())
        masks = visible_masks(x)
        for name, widths in BF16_Q_WIDTHS.items():
            if w not in widths:
                continue
            key = name + "_bf16"
            kernel = lambda fn=getattr(dk, name), a=decode_args(xb, name): fn(*a)
            plain = lambda fn=getattr(dk, name + "_ref"), a=decode_args(xb, name): fn(*a)
            out = kernel()
            torch.cuda.synchronize()
            ref = plain()
            require(out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all()), f"{key} w={w}: {out.dtype}")
            err = float((out.float() - ref.float()).abs().max())
            limit = bf16_ulp(float(ref.float().abs().max()))
            print(f"[kernels] {key} w={w}: max |kernel - plain| = {err:.3e} (one bf16 ulp of the output's "
                  f"largest entry: {limit:.3e})")
            require(err <= limit, f"{key} w={w}: error {err} > {limit}")
            row = rows.setdefault(key, {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if w != PATH_W[name]:
                continue
            t = dict(ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush))
            t["bound_ms"], t["bound_by"] = bound_ms(xb, name)
            t["library_ms"], library = None, "none: no PyTorch call dequantizes int8 pages inside attention"
            if not name.endswith("_quant"):
                if name.startswith("paged"):
                    safe = x["tables"].long().clamp(0, x["k_pool"].shape[0] - 1)
                    kv = tuple(p[safe].reshape(x["q"].shape[0], -1, *p.shape[2:]) for p in (x["k_pool"], x["v_pool"]))
                else:
                    kv = (x["k_cache"], x["v_cache"])
                mask = masks[name][0][:, None]  # [b, 1, w, L]
                qt, kt, vt = xb["q"].transpose(1, 2), kv[0].bfloat16().transpose(1, 2), kv[1].bfloat16().transpose(1, 2)
                sdpa = lambda qt=qt, kt=kt, vt=vt, mask=mask: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
                t["library_ms"] = time_ms(sdpa, flush)
                library = f"bf16 sdpa {t['library_ms']:.4f} ms (K/V cast to bf16 before the timer)"
            fp32 = lambda fn=getattr(dk, name), a=decode_args(x, name): fn(*a)
            t["device_ms"], fp32_dev = device_ms(kernel, flush), device_ms(fp32, flush)
            row.update(t)
            print(f"[kernels] {key} w={w}: {t['ms']:.4f} ms, device {t['device_ms']} ms beside fp32 q's "
                  f"device {fp32_dev} ms (bound {t['bound_ms']:.4f} ms, {t['bound_by']}), plain "
                  f"{t['plain_ms']:.4f} ms, library {library}")
    return rows


# the edges of the decode kernels' card tests (tests/test_torch_cuda.py):
# head dims short of a tile (16), an int8 row of an odd number of 8-byte
# words (24: 8-byte loads), at the tiles' top (256) and past it (320, on
# decode_kernel.cu's body, which stages head_dim in pieces), as (head_dim,
# max_len, page): a ragged max_len at 2-row pages, the serving shape, and
# the wide head at 16-row pages
SPLIT_BODY_EDGES = ((16, 250, 2), (24, 250, 2), (128, 512, 16), (256, 250, 2), (320, 128, 16))
SPLIT_BODY_WIDTHS = {
    "flash_verify": (1, 5, 13, 64),
    "paged_flash_verify": (1, 5, 13, 64),
    "paged_flash_verify_quant": (1, 5, 13, 64),
    "flash_verify_tree": (1, 13, 33, 64),
    "paged_flash_verify_tree": (1, 13, 33, 64),
    "paged_flash_verify_tree_quant": (1, 13, 33, 64),
}


def check_split_body_edges(device="cuda"):
    """All six decode kernels against their plain versions at the card
    tests' edges, at fp32 and at bf16 q: each width of SPLIT_BODY_WIDTHS
    at each shape of SPLIT_BODY_EDGES, with lengths 0 and max_len - w, a
    sentinel hole, a dead row that must give exactly 0 (on the contiguous
    cache of #4 and #7 the last row at length -w, which sees nothing) and
    (for #6 and #9) a scale-0 page (kernel_inputs), called twice: one
    launch counted per call under the kernel's own name (name + "_bf16"
    at bf16 q), the two outputs bit-identical, the error within
    ATOL_KERNEL (summation order over up to 320 columns of int8 values up
    to 127 x 0.05 moves #9 by up to ~2.5e-5; ATOL_SPEC_KERNEL holds at the
    path's head_dim 64, check_spec_kernels), at bf16 q within one bf16
    ulp of the output's largest entry beyond it. At head_dim 320 the
    wrappers take decode_kernel.cu's body, by head_dim alone, w = 64
    included (its shared memory no longer grows with head_dim; it raised
    before). The kernels line keeps the errors at the path's shapes."""
    import torch

    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk

    device = torch.device(device)
    for name, widths in SPLIT_BODY_WIDTHS.items():
        worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
        for w in widths:
            for d, max_len, page in SPLIT_BODY_EDGES:
                h = 16 if max_len == 512 else 2
                x = kernel_inputs(device, w, h=h, d=d, max_len=max_len, page=page,
                                  num_pages=8 * (max_len // page))
                if name in ("flash_verify", "flash_verify_tree"):  # the dead row of the contiguous cache
                    x["lengths"] = x["lengths"].clone()
                    x["lengths"][-1] = -w
                for qd in (torch.float32, torch.bfloat16):
                    args = decode_args(dict(x, q=x["q"].to(qd)), name)
                    key = name + ("_bf16" if qd == torch.bfloat16 else "")
                    fn = getattr(dk, name)
                    case = f"{key} w={w} d={d} max_len={max_len} page={page}"
                    dk.reset_launches()
                    out, again = fn(*args), fn(*args)
                    torch.cuda.synchronize()
                    require(dk.LAUNCHES == dict(dict.fromkeys(dk.LAUNCHES, 0), **{key: 2}), f"{case}: {dk.LAUNCHES}")
                    ref = getattr(dk, name + "_ref")(*args)
                    err = float((out.float() - ref.float()).abs().max())
                    limit = ATOL_KERNEL + (bf16_ulp(float(ref.float().abs().max())) if qd == torch.bfloat16 else 0.0)
                    require(out.dtype == qd and bool(torch.isfinite(out).all()) and err <= limit,
                            f"{case}: error {err} > {limit}")
                    require(torch.equal(out, again), f"{case}: two calls differ")
                    require(float(out[-1].float().abs().max()) == 0.0, f"{case}: the dead row is not 0")
                    worst[qd] = max(worst[qd], err)
        print(f"[kernels] {name} at widths {widths} x (head_dim, max_len, page) {SPLIT_BODY_EDGES}: "
              f"max |kernel - plain| = {worst[torch.float32]:.3e} at fp32 q (atol {ATOL_KERNEL}), "
              f"{worst[torch.bfloat16]:.3e} at bf16 q (atol {ATOL_KERNEL} + one bf16 ulp), repeat calls "
              f"bit-identical, dead rows 0")


def smi_sample() -> str:
    """The card's SM clock, its maximum, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def warm_card(seconds=2.0):
    """Keep the card busy with fp32 matrix products for `seconds`, so the
    timings that follow start at its working clock, not its idle one;
    then read one profiler session, since the first kernel whose device
    time a process reads can come out inflated (#4's in one run: 0.0564
    ms against 0.0155 read later in another process)."""
    import torch

    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(8):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()
    device_ms(lambda: torch.tanh(a), lambda: a.zero_())


# -- 3. serve the flagship LM ----------------------------------------------------


def build_lm(device, layers, hidden, heads, vocab, max_seqs, max_len, seed=SEED, mixed=False):
    """The decoder LM from seeded weights; `mixed` compiles it with
    allow_mixed_precision (the same float32 weights from the same seed)."""
    from flexflow_tpu_torch import DataType, FFConfig, FFModel
    from flexflow_tpu_torch.models import build_decoder_lm

    model = FFModel(FFConfig(batch_size=max_seqs, seed=seed, allow_mixed_precision=mixed))
    tok = model.create_tensor([max_seqs, max_len], dtype=DataType.INT32, name="tokens")
    build_decoder_lm(
        model, tok, vocab_size=vocab, hidden=hidden, num_heads=heads,
        num_layers=layers, ff_dim=4 * hidden,
    )
    model.compile(device=device)
    return model


def mixed_requests(vocab, max_len, n):
    """bench_serve.py's default stream: short and long continuations
    interleaved, prompts of 1-6 tokens."""
    from flexflow_tpu_torch.serving import Request

    short, long_ = max(2, max_len // 16), max(8, max_len // 2 - 8)
    return [
        Request(
            rid=i,
            prompt=[(i * 7 + j) % vocab for j in range(1 + i % 6)],
            max_new_tokens=short if i % 2 == 0 else long_,
        )
        for i in range(n)
    ]


def serve(model, requests, instrument=None, **serve_kw):
    """Run `requests` to completion on a fresh scheduler; returns
    (finished requests, stats, launches per kernel during the run, the
    KV cache). `instrument(scheduler)` runs before the requests do."""
    import torch

    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
    from flexflow_tpu_torch.serving import ServeConfig, build_scheduler

    cfg = dict(max_seqs=FLAGSHIP["max_seqs"], max_seq_len=FLAGSHIP["max_len"])
    cfg.update(serve_kw)
    sched, _, cache = build_scheduler(model, ServeConfig(**cfg))
    if instrument is not None:
        instrument(sched)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dk.reset_launches()
    done = sched.run(requests)
    launches = dict(dk.LAUNCHES)
    return done, sched.stats, launches, cache


def record_top2(sched, top):
    """Wrap a plain synchronous scheduler's prefill and the reconciles of
    its chunk and decode steps so that top[rid][i] is (gap, first,
    second, value): the gap between the two largest logits its engine saw
    when it picked the request's i-th generated token, those two tokens
    and the largest logit (bf16 logits are read as f32). A chunk step's
    record is replaced by the next one's until the request's final chunk,
    which gives its next token; a preempted request's re-admission keeps
    the records of the tokens it has."""
    engine = sched.engine
    prefill, decode, chunk = engine.prefill, engine.decode_reconcile, engine.prefill_chunk_reconcile

    def top2(logits):
        vals, ids = logits.float().topk(2, dim=-1)
        return (vals[:, 0] - vals[:, 1]).cpu().numpy(), ids.cpu().numpy(), vals[:, 0].cpu().numpy()

    def put(slot, rows, row):
        # the record of the request's next token (a preempted request's
        # re-admission keeps the records of the tokens it has)
        req = sched.running[int(slot)]
        gaps, ids, vals = rows
        top[req.rid] = top.get(req.rid, [])[: len(req.generated)] + [
            (float(gaps[row]), *map(int, ids[row]), float(vals[row]))]

    def prefill_rec(params, prompts, slots):
        nxt, last = prefill(params, prompts, slots)
        rows = top2(last)
        for i, s in enumerate(slots):
            put(s, rows, i)
        return nxt, last

    def decode_rec(step):
        nxt, logits = decode(step)
        rows = top2(logits)
        for s in np.nonzero(step.active)[0]:
            put(s, rows, s)
        return nxt, logits

    def chunk_rec(step):
        nxt, logits = chunk(step)
        rows = top2(logits)
        for s in np.nonzero(step.active)[0]:
            put(s, rows, s)
        return nxt, logits

    engine.prefill, engine.decode_reconcile, engine.prefill_chunk_reconcile = prefill_rec, decode_rec, chunk_rec


def rows_used(logits, plan):
    """The verify rows whose logits picked the tokens a commit emits: a
    linear draft's accepted prefix and one more, a tree's root and its
    accepted path."""
    from flexflow_tpu_torch.serving import accept_drafts, accept_tree

    if isinstance(plan, list):  # a linear draft
        return list(range(accept_drafts(logits, plan)[0] + 1))
    return [0] + [1 + n for n in accept_tree(logits, plan)[0]]


def record_spec_top(sched, top, out):
    """Wrap a speculative scheduler's commits so that out[rid][i] is the
    gap its verify logits put between the plain run's top two tokens
    (`top`, record_top2) behind the request's i-th generated token: held
    against the plain run's own gap, the logit noise between the two
    runs' GEMM shapes."""
    def wrap(commit):
        def recorded(step, logits):
            for slot, plan in (step.tree_plan or step.plan).items():
                req = step.participants[slot]
                if sched.running.get(slot) is not req:
                    continue
                base = len(req.generated)
                for k, r in enumerate(rows_used(logits[slot], plan)):
                    if base + k < len(top[req.rid]):
                        _, t1, t2, _ = top[req.rid][base + k]
                        row = logits[slot, r]
                        out.setdefault(req.rid, {})[base + k] = float(row[t1] - row[t2])
            return commit(step, logits)

        return recorded

    sched._commit_verify = wrap(sched._commit_verify)
    sched._commit_verify_tree = wrap(sched._commit_verify_tree)


def serve_flagship(device, layers=FLAGSHIP["layers"]):
    from flexflow_tpu_torch.serving import Request, RequestStatus, latency_percentiles

    geo = dict(FLAGSHIP, layers=layers)
    t0 = time.perf_counter()
    model = build_lm(device, **geo)
    nparams = sum(w.numel() for ws in model.params.values() for w in ws)
    print(f"[serve] flagship LM: {nparams / 1e6:.1f} M params, built in {time.perf_counter() - t0:.2f} s")
    # warm-up (allocator, library handles); not measured
    serve(model, [Request(rid=i, prompt=[1 + i], max_new_tokens=8) for i in range(4)])
    done, stats, launches, _ = serve(model, mixed_requests(geo["vocab"], geo["max_len"], NUM_REQUESTS))
    bad = [(r.rid, r.status, r.error) for r in done if r.status != RequestStatus.FINISHED]
    require(len(done) == NUM_REQUESTS and not bad, f"requests not FINISHED: {bad}")
    require(
        launches["paged_flash_verify"] == stats.decode_steps * layers,
        f"paged kernel launches {launches['paged_flash_verify']} != "
        f"{stats.decode_steps} decode steps x {layers} layers",
    )
    require(launches["flash_verify"] == 0, "the paged path launched the contiguous kernel")
    ttft = latency_percentiles(done, (50, 95), metric="ttft")
    summary = dict(
        requests=len(done),
        tokens=stats.tokens_generated,
        elapsed_s=stats.elapsed_s,
        tokens_per_s=stats.tokens_per_s,
        ttft_p50_ms=1e3 * ttft[50],
        ttft_p95_ms=1e3 * ttft[95],
        decode_steps=stats.decode_steps,
        mean_decode_step_ms=1e3 * stats.mean_decode_step_s,
        prefill_batches=stats.prefill_batches,
        mean_prefill_ms=1e3 * stats.prefill_s / max(1, stats.prefill_batches),
        occupancy=stats.occupancy,
        paged_kernel_launches=launches["paged_flash_verify"],
    )
    print("[serve] " + json.dumps(summary))
    return model, summary, launches, {r.rid: list(r.generated) for r in done}


def profile_decode(model, steps=16, label="decode", kernel=None, skip=0, **serve_kw):
    """Device time by kernel over a window of `steps` scheduler
    iterations, all slots busy (torch.profiler): decode steps, or verify
    steps under a spec ServeConfig (`serve_kw`). The window opens after
    2-token prompts and `skip` more steps, so its contexts run from
    skip + 3 tokens on. With `kernel`, a wrapper of KERNEL_SYMBOLS, also
    that kernel's device time per wrapper call beside the device time of
    the step's GEMMs. None when the profiler sees no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
    from flexflow_tpu_torch.serving import Request, ServeConfig, build_scheduler

    sched, _, _ = build_scheduler(
        model, ServeConfig(max_seqs=FLAGSHIP["max_seqs"], max_seq_len=FLAGSHIP["max_len"], **serve_kw)
    )
    # a verify step may commit up to w tokens per slot
    budget = min(FLAGSHIP["max_len"] - 8, 64 * (steps + 4) + skip)
    for i in range(FLAGSHIP["max_seqs"]):
        sched.submit(Request(rid=i, prompt=[i + 1, i + 2], max_new_tokens=budget))
    for _ in range(1 + skip):  # admission prefill + first decodes, outside the window
        sched.step()
    torch.cuda.synchronize()
    calls0 = dict(dk.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # device-side kernel and memcpy events only: the CPU ops that launch
    # them carry the same device time again
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    device_us = sum(e.self_device_time_total for e in events)
    if not events or device_us <= 0:
        print("[profile] no device time recorded: device busy share not measured")
        return None
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    out = dict(
        label=label,
        steps=steps,
        wall_ms_per_step=1e3 * wall_s / steps,
        device_ms_per_step=device_us / 1e3 / steps,
        device_busy_share=device_us / 1e6 / wall_s,
        device_ops_per_step=sum(e.count for e in events) / steps,
        top=[(e.key[:60], e.self_device_time_total / 1e3 / steps, e.count // steps) for e in top],
    )
    if kernel is not None:
        out["kernel"] = step_breakdown(label, events, steps, kernel, dk.LAUNCHES[kernel] - calls0[kernel])
    print("[profile] " + json.dumps(out))
    return out


def step_breakdown(label, events, steps, kernel, calls):
    """The profiled window's device time per step by part: `kernel` (a
    wrapper of KERNEL_SYMBOLS; also per call, `calls` of them), the GEMMs
    (cuBLAS, fp32 or bf16), and the dtype casts (copy kernels: under mixed
    precision the weights mm_operands casts to bf16 every step, and the
    activations)."""
    kern_us = sum(e.self_device_time_total for e in events if any(k in e.key for k in KERNEL_SYMBOLS[kernel]))
    gemm_us = sum(e.self_device_time_total for e in events
                  if any(g in e.key.lower() for g in ("gemm", "gemv", "nvjet", "cutlass")))
    casts = [e for e in events if "copy" in e.key.lower() and not e.key.startswith("Memcpy")]
    out = dict(
        name=kernel,
        calls=calls,
        device_ms_per_call=kern_us / 1e3 / calls if calls and kern_us else None,
        device_ms_per_step=kern_us / 1e3 / steps,
        gemm_ms_per_step=gemm_us / 1e3 / steps,
        cast_ms_per_step=sum(e.self_device_time_total for e in casts) / 1e3 / steps,
        casts_per_step=sum(e.count for e in casts) / steps,
    )
    per_call = "not measured" if out["device_ms_per_call"] is None else f"{out['device_ms_per_call']:.4f} ms"
    print(f"[profile] {label}: {kernel} {per_call} of device time per call ({calls} calls, "
          f"{out['device_ms_per_step']:.4f} ms per step) beside the step's GEMMs "
          f"{out['gemm_ms_per_step']:.4f} ms and casts {out['cast_ms_per_step']:.4f} ms "
          f"({out['casts_per_step']:.0f} copy kernels) per step")
    return out


# -- 4. cross-checks on the card -------------------------------------------------


def check_layouts(device, layers=2):
    """Slot and paged layouts give token-identical greedy streams; the
    slot run goes through the contiguous kernel."""
    from flexflow_tpu_torch.serving import RequestStatus

    geo = dict(FLAGSHIP, layers=layers)
    model = build_lm(device, **geo)
    streams, launches = {}, {}
    for layout in ("slot", "paged"):
        reqs = mixed_requests(geo["vocab"], 64, 8)
        done, stats, launches[layout], _ = serve(model, reqs, kv_layout=layout)
        require(all(r.status == RequestStatus.FINISHED for r in done), f"{layout}: unfinished requests")
        kernel = "flash_verify" if layout == "slot" else "paged_flash_verify"
        require(
            launches[layout][kernel] == stats.decode_steps * layers,
            f"{layout}: {kernel} launches {launches[layout][kernel]} != "
            f"{stats.decode_steps} x {layers}",
        )
        streams[layout] = {r.rid: list(r.generated) for r in done}
    require(streams["slot"] == streams["paged"], "slot and paged greedy streams differ")
    print(f"[checks] slot == paged greedy streams for {len(streams['slot'])} requests "
          f"at {layers} layers: True")
    return model, launches


def check_decode_logits(model, n_new=12, ulps=None):
    """Cached decode logits of 2 requests vs a full no-cache forward of
    prompt + generated tokens: within ATOL_LOGITS, or under mixed
    precision within `ulps` bf16 ulps of the logits' largest magnitude."""
    import torch

    from flexflow_tpu_torch.serving import ServeConfig, build_scheduler

    _, engine, cache = build_scheduler(
        model, ServeConfig(max_seqs=2, max_seq_len=FLAGSHIP["max_len"])
    )
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    slots = [cache.alloc(len(p), len(p) + n_new) for p in prompts]
    nxt, last = engine.prefill(model.params, prompts, slots)
    seqs = [list(p) + [int(t)] for p, t in zip(prompts, nxt)]
    step_logits = [[last[i]] for i in range(2)]
    tokens = np.zeros(cache.spec.max_seqs, dtype=np.int32)
    active = np.zeros(cache.spec.max_seqs, dtype=bool)
    active[slots] = True
    for _ in range(n_new - 1):
        tokens[slots] = [s[-1] for s in seqs]
        nxt, logits = engine.decode(model.params, tokens, active)
        for i, s in enumerate(slots):
            seqs[i].append(int(nxt[s]))
            step_logits[i].append(logits[s])
    err = big = 0.0
    for i, p in enumerate(prompts):
        full = model.forward({"tokens": np.asarray([seqs[i][:-1]], dtype=np.int32)})[0].float()
        got = torch.stack(step_logits[i]).float()
        err = max(err, float((got - full[len(p) - 1:]).abs().max()))
        big = max(big, float(full.abs().max()))
    limit = ATOL_LOGITS if ulps is None else ulps * bf16_ulp(big)
    what = f"atol {ATOL_LOGITS}" if ulps is None else \
        f"{ulps} bf16 ulps of the largest |logit| {big:.3f}: {limit:.3e}; {err / bf16_ulp(big):.2f} ulps"
    print(f"[checks] decode logits vs full forward{' (mixed precision)' if ulps else ''}: max |diff| = "
          f"{err:.3e} ({what})")
    require(err <= limit, f"decode logits differ from the full forward by {err} > {limit}")
    return err


# -- 4b. speculative decoding and int8 pools -----------------------------------------


def long_requests(vocab, max_len, n):
    """bench_serve._long_requests: prompts of 1-4 tokens and max_len - 16
    new tokens each — the acceptance-friendly speculative regime (greedy
    random LMs enter cycles that prompt lookup drafts)."""
    from flexflow_tpu_torch.serving import Request

    return [
        Request(rid=i, prompt=[(i * 5 + j) % vocab for j in range(1 + i % 4)], max_new_tokens=max_len - 16)
        for i in range(n)
    ]


def pool_bytes(cache) -> int:
    """Bytes of the KV pools (and the int8 scale side pools)."""
    pools = [cache.k, cache.v, getattr(cache, "k_scale", {}), getattr(cache, "v_scale", {})]
    return sum(t.numel() * t.element_size() for p in pools for t in p.values())


def compare_streams(name, done, plain, top, spec_top, near_tie):
    """Each stream of `done` equals its plain leg's (`plain`), or first
    differs where the plain run's top two logits lay within `near_tie`;
    the spec run's gaps between those two tokens stay within `near_tie`
    of the plain run's over the tokens before any divergence. `near_tie`
    is a number, or a function of the token's largest logit (the bf16
    limits, in ulps of it). Returns (near-ties as (request, token index,
    gap), the largest |spec gap - plain gap| over those tokens, and that
    largest as a share of its token's limit)."""
    limit = near_tie if callable(near_tie) else (lambda value: near_tie)
    ties, noise, share = [], 0.0, 0.0
    for r in done:
        want, got = plain[r.rid], list(r.generated)
        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
        for j, g in spec_top.get(r.rid, {}).items():
            if j < i:
                diff = abs(g - top[r.rid][j][0])
                noise = max(noise, diff)
                share = max(share, diff / limit(top[r.rid][j][3]))
        if got == want:
            continue
        gap, value = top[r.rid][i][0::3] if i < len(top[r.rid]) else (float("inf"), 0.0)
        require(
            gap <= limit(value),
            f"{name}: request {r.rid} first differs from its plain stream at token {i}, "
            f"where the plain run's top two logits are {gap:.3e} apart (> {limit(value):.3e})",
        )
        print(f"[spec] {name}: request {r.rid} first differs from its plain stream at token {i}, a near-tie: "
              f"the plain run's top two logits are {gap:.3e} apart (<= {limit(value):.3e}), which the two "
              f"runs' GEMM shapes may order either way")
        ties.append((r.rid, i, gap))
    require(share <= 1.0, f"{name}: spec and plain logit gaps differ by up to {share:.2f} of the near-tie limit")
    return ties, noise, share


def serve_leg(name, model, layers, kernel, plain=None, near_tie=None, **serve_kw):
    """One serving leg of SPEC_REQUESTS long requests: every request
    finishes at full length, `kernel` launches steps x layers times and
    no other decode kernel launches. A plain leg (plain=None) records its
    top two logits per token; a spec leg's streams are held against
    `plain`, (streams, top) of its plain leg, up to `near_tie` (by
    default NEAR_TIE, NEAR_TIE_INT8 on int8 pools). Returns (streams,
    top, summary, launches)."""
    from flexflow_tpu_torch.serving import latency_percentiles

    reqs = long_requests(FLAGSHIP["vocab"], FLAGSHIP["max_len"], SPEC_REQUESTS)
    if plain is None:
        top = {}
        instrument = lambda sched: record_top2(sched, top)
    else:
        top, spec_top = plain[1], {}
        instrument = lambda sched: record_spec_top(sched, top, spec_top)
    done, stats, launches, cache = serve(model, reqs, instrument=instrument, **serve_kw)
    bad = [(r.rid, r.status, r.error, len(r.generated)) for r in done
           if not r.ok or len(r.generated) != r.max_new_tokens]
    require(len(done) == SPEC_REQUESTS and not bad, f"{name}: requests not FINISHED at full length: {bad}")
    spec = "spec_draft" in serve_kw
    steps = stats.verify_steps if spec else stats.decode_steps
    require(steps > 0 and (stats.decode_steps == 0 or not spec), f"{name}: {stats}")
    require(
        launches[kernel] == steps * layers,
        f"{name}: {kernel} launches {launches[kernel]} != {steps} steps x {layers} layers",
    )
    others = {k: n for k, n in launches.items() if k != kernel and n}
    require(not others, f"{name}: other decode kernels launched: {others}")
    if near_tie is None:
        near_tie = NEAR_TIE_INT8 if serve_kw.get("kv_dtype") == "int8" else NEAR_TIE
    ties, noise, share = compare_streams(name, done, plain[0], top, spec_top, near_tie) if spec else ([], None, None)
    step_s = stats.verify_s if spec else stats.decode_s
    ttft = latency_percentiles(done, (50, 95), metric="ttft")
    summary = dict(
        leg=name,
        layers=layers,
        tokens=stats.tokens_generated,
        elapsed_s=stats.elapsed_s,
        tokens_per_s=stats.tokens_per_s,
        decode_steps=stats.decode_steps,
        verify_steps=stats.verify_steps,
        mean_step_ms=1e3 * step_s / steps,
        ttft_p50_ms=1e3 * ttft[50],
        ttft_p95_ms=1e3 * ttft[95],
        acceptance_rate=stats.acceptance_rate,
        accepted_per_verify=stats.draft_tokens_accepted / stats.verify_steps if spec else None,
        tree_nodes_per_verify=stats.tree_nodes_proposed / stats.verify_steps if spec else None,
        kv_pool_bytes=pool_bytes(cache),
        kernel=kernel,
        launches=launches[kernel],
        near_ties=len(ties),
        max_gap_noise=noise,
        gap_noise_share_of_limit=share,
    )
    print("[spec] " + json.dumps(summary))
    return {r.rid: list(r.generated) for r in done}, top, summary, launches


def serve_spec(device, layers=FLAGSHIP["layers"], small_layers=2):
    """The flagship LM serves SPEC_REQUESTS long requests in four legs —
    (a) plain fp32 paged (#5), (b) tree spec fp32 paged (w 13, #8), (c)
    plain int8 paged (#6 at w 1), (d) tree spec int8 paged (#9) — and at
    `small_layers` layers (e) tree spec on the slot layout (#7) beside a
    plain slot run, and (f) linear spec on int8 pools (#6 at w 5) beside
    a plain int8 run. Greedy spec streams equal their plain leg's, near-
    ties excepted (compare_streams). On the card it also profiles a
    window of (a)'s, (b)'s, (c)'s and (d)'s steps and of the plain slot
    run's (#4), and of (a)'s, (c)'s and the slot run's again at ~250-token
    contexts. Returns the launches of
    #6-#9 on their legs: (c), (e), (b) and (d), and {leg: summary}."""
    from flexflow_tpu_torch.serving import Request

    warm = lambda: [Request(rid=i, prompt=[1 + i, 2 + i], max_new_tokens=8) for i in range(4)]
    model = build_lm(device, **dict(FLAGSHIP, layers=layers))
    int8, tree_int8 = dict(kv_dtype="int8"), dict(TREE, kv_dtype="int8")
    for kw in ({}, TREE, int8, tree_int8):  # warm-up, not measured
        serve(model, warm(), **kw)
    summaries = {}
    a, a_top, summaries["a"], _ = serve_leg("a: plain, fp32 paged", model, layers, "paged_flash_verify")
    *_, summaries["b"], b_launches = serve_leg("b: tree spec, fp32 paged", model, layers, "paged_flash_verify_tree",
                                               plain=(a, a_top), **TREE)
    c, c_top, summaries["c"], c_launches = serve_leg("c: plain, int8 paged", model, layers,
                                                     "paged_flash_verify_quant", **int8)
    *_, summaries["d"], d_launches = serve_leg("d: tree spec, int8 paged", model, layers,
                                               "paged_flash_verify_tree_quant", plain=(c, c_top), **tree_int8)
    if model.device.type == "cuda":
        for label, kernel, kw in (
            ("a: decode, fp32 paged", "paged_flash_verify", {}),
            ("b: tree spec verify, fp32 paged", "paged_flash_verify_tree", TREE),
            ("c: decode, int8 paged", "paged_flash_verify_quant", int8),
            ("d: tree spec verify, int8 paged", "paged_flash_verify_tree_quant", tree_int8),
        ):
            profile_decode(model, label=label, kernel=kernel, **kw)
        # the plain legs' kernels at the cell's own contexts (~250 tokens)
        for label, kernel, kw in (("a: decode at ~250-token contexts", "paged_flash_verify", {}),
                                  ("c: decode at ~250-token contexts", "paged_flash_verify_quant", int8)):
            profile_decode(model, label=label, kernel=kernel, skip=LONG_WINDOW_SKIP, **kw)
    del model
    small = build_lm(device, **dict(FLAGSHIP, layers=small_layers))
    slot, linear_int8 = dict(kv_layout="slot"), dict(LINEAR, kv_dtype="int8")
    for kw in (slot, dict(TREE, **slot), int8, linear_int8):
        serve(small, warm(), **kw)
    s, s_top, summaries["slot"], _ = serve_leg("plain, slot", small, small_layers, "flash_verify", **slot)
    *_, summaries["e"], e_launches = serve_leg("e: tree spec, slot", small, small_layers, "flash_verify_tree",
                                               plain=(s, s_top), **TREE, **slot)
    i, i_top, *_ = serve_leg("plain, int8 paged", small, small_layers, "paged_flash_verify_quant", **int8)
    serve_leg("f: linear spec, int8 paged", small, small_layers, "paged_flash_verify_quant",
              plain=(i, i_top), **linear_int8)
    if small.device.type == "cuda":
        profile_decode(small, label="slot: decode, 2 layers", kernel="flash_verify", **slot)
        profile_decode(small, label="slot: decode at ~250-token contexts", kernel="flash_verify",
                       skip=LONG_WINDOW_SKIP, **slot)
    return {
        "paged_flash_verify_quant": c_launches["paged_flash_verify_quant"],
        "flash_verify_tree": e_launches["flash_verify_tree"],
        "paged_flash_verify_tree": b_launches["paged_flash_verify_tree"],
        "paged_flash_verify_tree_quant": d_launches["paged_flash_verify_tree_quant"],
    }, summaries


# -- 4c. multi-step decode as CUDA-graph windows ------------------------------------


def profile_multistep(model, label, iters, kernel=None, **serve_kw):
    """Device time against wall time per decode step over `iters`
    scheduler iterations with all slots busy: plain decode steps, or fused
    windows under decode_multistep (the first window, which captures the
    graph, runs before the profiled ones). Device time is the profiler's
    kernels and copies; the CUDA events around the iterations give the
    device timeline's span beside it. None when the profiler sees no
    device activity. With `kernel`, also the window's breakdown
    (step_breakdown)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
    from flexflow_tpu_torch.serving import Request, ServeConfig, build_scheduler

    sched, _, _ = build_scheduler(
        model, ServeConfig(max_seqs=FLAGSHIP["max_seqs"], max_seq_len=FLAGSHIP["max_len"], **serve_kw)
    )
    for i in range(FLAGSHIP["max_seqs"]):
        sched.submit(Request(rid=i, prompt=[i + 1, i + 2], max_new_tokens=FLAGSHIP["max_len"] - 16))
    for _ in range(2):  # admission prefill, then a first step or window
        sched.step()
    torch.cuda.synchronize()
    steps0 = sched.stats.decode_steps
    calls0 = dict(dk.LAUNCHES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            sched.step()
        end.record()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    steps = sched.stats.decode_steps - steps0
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    device_us = sum(e.self_device_time_total for e in events)
    out = dict(
        label=label,
        decode_steps=steps,
        wall_ms_per_step=1e3 * wall_s / steps,
        device_ms_per_step=device_us / 1e3 / steps if device_us > 0 else None,
        device_busy_share=device_us / 1e6 / wall_s if device_us > 0 else None,
        event_span_ms_per_step=start.elapsed_time(end) / steps,
        device_ops_per_step=sum(e.count for e in events) / steps,
    )
    if device_us <= 0:
        print(f"[multistep] {label}: the profiler recorded no device time: device ms not measured")
    elif kernel is not None:
        out["kernel"] = step_breakdown(label, events, steps, kernel, dk.LAUNCHES[kernel] - calls0[kernel])
    print("[multistep] profile " + json.dumps(out))
    return out


def multistep_leg(name, model, layers, kernel, **serve_kw):
    """SPEC_REQUESTS long requests (one per slot, so that every iteration
    can fuse), eager (one decode step per iteration) and then with
    decode_multistep=True (windows of up to MULTISTEP_STEPS steps, CUDA
    graphs), each with a profiled window of busy slots. Gates: every
    request finishes at full length, `kernel` launches decode steps x
    layers times in both runs (a graph's replays counted) and no other
    decode kernel launches, the graph run's streams equal the eager
    run's token for token, it fused, and one graph served it. Returns
    {mode: summary}."""
    reqs = lambda: long_requests(FLAGSHIP["vocab"], FLAGSHIP["max_len"], SPEC_REQUESTS)
    out, streams = {}, {}
    for mode, kw in (("eager", {}), ("graph", dict(decode_multistep=True, max_fused_steps=MULTISTEP_STEPS))):
        done, stats, launches, _ = serve(model, reqs(), **serve_kw, **kw)
        bad = [(r.rid, r.status, r.error, len(r.generated)) for r in done
               if not r.ok or len(r.generated) != r.max_new_tokens]
        require(len(done) == SPEC_REQUESTS and not bad, f"{name} {mode}: requests not FINISHED at full length: {bad}")
        require(
            launches[kernel] == stats.decode_steps * layers,
            f"{name} {mode}: {kernel} launches {launches[kernel]} != {stats.decode_steps} steps x {layers} layers",
        )
        others = {k: n for k, n in launches.items() if k != kernel and n}
        require(not others, f"{name} {mode}: other decode kernels launched: {others}")
        streams[mode] = {r.rid: list(r.generated) for r in done}
        prof = profile_multistep(model, f"{name}, {mode}", 16 if mode == "eager" else 4, **serve_kw, **kw)
        out[mode] = dict(
            leg=name,
            mode=mode,
            layers=layers,
            tokens=stats.tokens_generated,
            elapsed_s=stats.elapsed_s,
            tokens_per_s=stats.tokens_per_s,
            decode_steps=stats.decode_steps,
            step_ms=1e3 * stats.mean_decode_step_s,
            windows=stats.multistep_windows,
            fused_steps=stats.multistep_steps,
            host_syncs_per_token=stats.host_syncs_per_token,
            graphs=stats.multistep_cache_entries,
            kernel=kernel,
            launches=launches[kernel],
            profiled_device_ms_per_step=prof["device_ms_per_step"],
            profiled_wall_ms_per_step=prof["wall_ms_per_step"],
            busy_share=prof["device_busy_share"],
        )
        print("[multistep] " + json.dumps(out[mode]))
    graph = out["graph"]
    require(streams["graph"] == streams["eager"], f"{name}: graph-window streams differ from the eager streams")
    require(graph["windows"] > 0 and graph["fused_steps"] > graph["windows"], f"{name}: nothing fused: {graph}")
    want = 1 if model.device.type == "cuda" else 0  # the CPU runs the core eagerly
    require(graph["graphs"] == want, f"{name}: {graph['graphs']} captured graphs, want {want}")
    print(f"[multistep] {name}: graph streams == eager streams for {len(streams['graph'])} requests; "
          f"{graph['tokens_per_s']:.1f} against {out['eager']['tokens_per_s']:.1f} tokens/s, "
          f"{graph['step_ms']:.3f} against {out['eager']['step_ms']:.3f} ms per decode step")
    return out


def multistep_burst(model, plain, layers=FLAGSHIP["layers"]):
    """The flagship burst (NUM_REQUESTS mixed requests on 8 slots) with
    decode_multistep=True: the queue holds fusing until only the tail is
    left. Gates: every request FINISHED, the streams equal the plain
    burst's (`plain`), #5 launches decode steps x layers times."""
    done, stats, launches, _ = serve(
        model, mixed_requests(FLAGSHIP["vocab"], FLAGSHIP["max_len"], NUM_REQUESTS),
        decode_multistep=True, max_fused_steps=MULTISTEP_STEPS,
    )
    bad = [(r.rid, r.status, r.error) for r in done if not r.ok]
    require(len(done) == NUM_REQUESTS and not bad, f"burst with decode_multistep: requests not FINISHED: {bad}")
    require({r.rid: list(r.generated) for r in done} == plain, "burst with decode_multistep: streams differ from plain")
    require(
        launches["paged_flash_verify"] == stats.decode_steps * layers,
        f"burst with decode_multistep: #5 launches {launches['paged_flash_verify']} != "
        f"{stats.decode_steps} x {layers}",
    )
    summary = dict(
        requests=len(done),
        tokens=stats.tokens_generated,
        elapsed_s=stats.elapsed_s,
        tokens_per_s=stats.tokens_per_s,
        decode_steps=stats.decode_steps,
        step_ms=1e3 * stats.mean_decode_step_s,
        windows=stats.multistep_windows,
        fused_steps=stats.multistep_steps,
        host_syncs_per_token=stats.host_syncs_per_token,
        graphs=stats.multistep_cache_entries,
    )
    print("[multistep] burst " + json.dumps(summary))
    return summary


# -- 4d. mixed-precision serving ------------------------------------------------------


def weight_cast_ms(model):
    """Device time of casting, once, every weight that mm_operands casts
    to bf16 in a mixed-precision step (those of LINEAR and
    MULTIHEAD_ATTENTION nodes; EMBEDDING gathers its f32 rows): what a
    bf16 weight cache would save per step. (ms, bytes read and written)."""
    import torch

    weights = [w for node in model.graph.nodes.values()
               if node.op_type.name in ("LINEAR", "MULTIHEAD_ATTENTION")
               for w in model.params.get(node.guid, []) if w.dim() >= 2 and w.dtype == torch.float32]
    cast = lambda: [w.to(torch.bfloat16) for w in weights]
    ms = time_ms(cast, lambda: None, iters=20, warmup=3)
    return ms, sum(6 * w.numel() for w in weights)


def bf16_near_tie(ulps):
    return lambda value: ulps * bf16_ulp(abs(value))


def serve_mixed(device, fp32, layers=FLAGSHIP["layers"], small_layers=2):
    """Phase 4d: the flagship LM compiled with allow_mixed_precision from
    phase 3's seeded weights serves (a) phase 3's burst on fp32 paged pools
    (#5 at bf16 q), (b) the long requests plain and with tree speculation
    on fp32 pools (#5, #8) and on int8 pools (#6, #9), (d) the plain fp32
    leg again as decode_multistep graph windows, whose streams must equal
    (b)'s eager plain streams token for token, and at `small_layers` layers
    (c) plain and tree spec on the slot layout (#4, #7) and its cached
    decode logits against the full no-cache mixed forward. Every request
    finishes, each leg's bf16-q kernel launches steps x layers times
    (replays counted) and no other decode kernel launches, fp32-q ones
    included; spec streams equal their plain leg's up to the bf16 near-tie
    limits (NEAR_TIE_BF16_ULPS). Each leg is printed beside the same leg's
    fp32 run of this call (`fp32`: {leg: summary}); (a) and (d) have a
    profiled window broken down into the bf16-q kernel, the GEMMs and the
    casts, beside the device time of casting the weights alone. Returns
    the launches of the six bf16-q entry points on their legs."""
    from flexflow_tpu_torch.serving import Request, RequestStatus, latency_percentiles

    cuda = device == "cuda"
    warm = lambda: [Request(rid=i, prompt=[1 + i, 2 + i], max_new_tokens=8) for i in range(4)]
    model = build_lm(device, mixed=True, **dict(FLAGSHIP, layers=layers))
    int8, tree_int8 = dict(kv_dtype="int8"), dict(TREE, kv_dtype="int8")
    for kw in ({}, TREE, int8, tree_int8):  # warm-up, not measured
        serve(model, warm(), **kw)
    launches, mixed = {}, {}

    # (a) phase 3's burst on the default paged fp32 pools
    done, stats, runs, cache = serve(model, mixed_requests(FLAGSHIP["vocab"], FLAGSHIP["max_len"], NUM_REQUESTS))
    bad = [(r.rid, r.status, r.error) for r in done if r.status != RequestStatus.FINISHED]
    require(len(done) == NUM_REQUESTS and not bad, f"4d (a): requests not FINISHED: {bad}")
    want = {k: 0 for k in runs}
    want["paged_flash_verify_bf16"] = stats.decode_steps * layers
    require(runs == want, f"4d (a): launches {runs}, want {want}")
    launches["paged_flash_verify_bf16"] = runs["paged_flash_verify_bf16"]
    ttft = latency_percentiles(done, (50, 95), metric="ttft")
    mixed["burst"] = dict(tokens_per_s=stats.tokens_per_s, mean_step_ms=1e3 * stats.mean_decode_step_s,
                          ttft_p50_ms=1e3 * ttft[50], ttft_p95_ms=1e3 * ttft[95], decode_steps=stats.decode_steps,
                          kv_pool_bytes=pool_bytes(cache), launches=launches["paged_flash_verify_bf16"])
    # (b) the long requests, plain and tree spec, fp32 and int8 pools
    tie, tie8 = bf16_near_tie(NEAR_TIE_BF16_ULPS), bf16_near_tie(NEAR_TIE_BF16_ULPS_INT8)
    a, a_top, mixed["a"], _ = serve_leg("4d b: mixed plain, fp32 paged", model, layers, "paged_flash_verify_bf16",
                                        near_tie=tie)
    *_, mixed["b"], runs = serve_leg("4d b: mixed tree spec, fp32 paged", model, layers,
                                     "paged_flash_verify_tree_bf16", plain=(a, a_top), near_tie=tie, **TREE)
    launches["paged_flash_verify_tree_bf16"] = runs["paged_flash_verify_tree_bf16"]
    c, c_top, mixed["c"], runs = serve_leg("4d b: mixed plain, int8 paged", model, layers,
                                           "paged_flash_verify_quant_bf16", near_tie=tie8, **int8)
    launches["paged_flash_verify_quant_bf16"] = runs["paged_flash_verify_quant_bf16"]
    *_, mixed["d"], runs = serve_leg("4d b: mixed tree spec, int8 paged", model, layers,
                                     "paged_flash_verify_tree_quant_bf16", plain=(c, c_top), near_tie=tie8,
                                     **tree_int8)
    launches["paged_flash_verify_tree_quant_bf16"] = runs["paged_flash_verify_tree_quant_bf16"]
    # (d) graph windows on fp32 pools: (b)'s plain streams, token for token
    kw = dict(decode_multistep=True, max_fused_steps=MULTISTEP_STEPS)
    done, stats, runs, _ = serve(model, long_requests(FLAGSHIP["vocab"], FLAGSHIP["max_len"], SPEC_REQUESTS), **kw)
    require(all(r.ok and len(r.generated) == r.max_new_tokens for r in done), "4d (d): unfinished requests")
    require({r.rid: list(r.generated) for r in done} == a, "4d (d): graph-window streams differ from (b)'s eager ones")
    want = {k: 0 for k in runs}
    want["paged_flash_verify_bf16"] = stats.decode_steps * layers
    require(runs == want, f"4d (d): launches {runs}, want {want}")
    require(stats.multistep_cache_entries == (1 if cuda else 0) and stats.multistep_steps > stats.multistep_windows,
            f"4d (d): {stats}")
    mixed["graph"] = dict(tokens_per_s=stats.tokens_per_s, mean_step_ms=1e3 * stats.mean_decode_step_s,
                          decode_steps=stats.decode_steps, windows=stats.multistep_windows,
                          host_syncs_per_token=stats.host_syncs_per_token)
    print(f"[mixed] 4d (d): graph streams == (b)'s eager plain streams for {len(done)} requests")
    if cuda:
        profile_decode(model, label="4d (a): mixed decode, fp32 paged", kernel="paged_flash_verify_bf16")
        prof = profile_multistep(model, "4d (d): mixed graph windows, fp32 paged", 4,
                                 kernel="paged_flash_verify_bf16", **kw)
        mixed["graph"].update(device_ms_per_step=prof["device_ms_per_step"], busy_share=prof["device_busy_share"])
        ms, nbytes = weight_cast_ms(model)
        print(f"[mixed] the weights mm_operands casts to bf16 every step, cast alone: {ms:.4f} ms of device time "
              f"per step ({nbytes / 1e9:.3f} GB read and written; {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    del model
    # (c) 2 layers on the slot layout
    small = build_lm(device, mixed=True, **dict(FLAGSHIP, layers=small_layers))
    slot = dict(kv_layout="slot")
    for kw in (slot, dict(TREE, **slot)):
        serve(small, warm(), **kw)
    s, s_top, mixed["slot"], runs = serve_leg("4d c: mixed plain, slot", small, small_layers, "flash_verify_bf16",
                                              near_tie=tie, **slot)
    launches["flash_verify_bf16"] = runs["flash_verify_bf16"]
    *_, mixed["e"], runs = serve_leg("4d c: mixed tree spec, slot", small, small_layers, "flash_verify_tree_bf16",
                                     plain=(s, s_top), near_tie=tie, **TREE, **slot)
    launches["flash_verify_tree_bf16"] = runs["flash_verify_tree_bf16"]
    check_decode_logits(small, ulps=CACHE_ULPS_BF16)
    del small
    keys = ("tokens_per_s", "mean_step_ms", "ttft_p50_ms", "ttft_p95_ms", "acceptance_rate", "kv_pool_bytes")
    for leg, theirs in fp32.items():
        ours = mixed.get(leg)
        if ours is not None:
            print(f"[mixed] leg {leg}: fp32 against mixed precision, same call: "
                  + json.dumps({k: [theirs.get(k), ours.get(k)] for k in keys if k in theirs or k in ours}))
    return launches


# -- 5. flash kernels vs plain versions --------------------------------------------


# -- 4e: serving features under real traffic -----------------------------------------------

FEATURE_T = 0.8
FEATURE_SEED = 1234
CHUNKED = dict(token_budget=128, chunk_size=16)
FEATURE_PAGES = 128  # (d): half the default pool of 8 x 512 / 16 pages
SYSTEM_PROMPT = 256  # (c): 16 pages of 16 tokens
CHUNK_WIDTHS = (16, 64)
CHUNK_KERNELS = ("flash_verify", "paged_flash_verify", "paged_flash_verify_quant")


def check_chunk_kernels(device="cuda"):
    """#4, #5 and #6 at the chunk steps' widths (w = 16 and 64; kernel_inputs'
    lengths put each row's staircase at a random cursor, 0 and max_len - w
    included) against their plain versions (ATOL_KERNEL), timed with
    their bounds and (#4, #5) masked SDPA on the same K/V, gathered from
    the pages before the timer starts, one [features] kernel line each."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk

    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    flush = lambda: flush_buf.zero_()
    for w in CHUNK_WIDTHS:
        x = kernel_inputs(device, w)
        masks = visible_masks(x)
        for name in CHUNK_KERNELS:
            kernel = lambda fn=getattr(dk, name), a=decode_args(x, name): fn(*a)
            plain = lambda fn=getattr(dk, name + "_ref"), a=decode_args(x, name): fn(*a)
            out = kernel()
            torch.cuda.synchronize()
            err = float((out - plain()).abs().max())
            require(bool(torch.isfinite(out).all()), f"{name} w={w}: non-finite output")
            require(err <= ATOL_KERNEL, f"{name} w={w}: error {err} > {ATOL_KERNEL}")
            t = dict(name=name, w=w, max_abs_err=err, ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush),
                     device_ms=device_ms(kernel, flush))
            t["bound_ms"], t["bound_by"] = bound_ms(x, name)
            t["library_ms"] = None  # no PyTorch call dequantizes int8 pages inside attention
            if name != "paged_flash_verify_quant":
                if name == "flash_verify":
                    kv = (x["k_cache"], x["v_cache"])
                else:
                    safe = x["tables"].long().clamp(0, x["k_pool"].shape[0] - 1)
                    kv = tuple(p[safe].reshape(x["q"].shape[0], -1, *p.shape[2:]) for p in (x["k_pool"], x["v_pool"]))
                qt, kt, vt = x["q"].transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2)
                mask = masks[name][0][:, None]
                t["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), flush)
            print("[features] kernel " + json.dumps(t))


def feature_requests(vocab, seed=SEED, long_new=32, short_new=64, long_first=False):
    """(b)'s traffic: 16 prompts of 96-448 seeded tokens (long_new new
    tokens each) interleaved with 16 prompts of 1-6 tokens (short_new);
    `long_first` submits the 16 long ones first ((d): eight long
    sequences in flight outgrow half the pool)."""
    from flexflow_tpu_torch.serving import Request

    rng = np.random.default_rng(seed + 4)
    reqs = []
    for i in range(16):
        n = int(rng.integers(96, 449))
        reqs.append(Request(rid=2 * i, prompt=[int(t) for t in rng.integers(1, vocab, n)], max_new_tokens=long_new))
        reqs.append(Request(rid=2 * i + 1, prompt=[(i * 7 + j) % vocab for j in range(1 + i % 6)],
                            max_new_tokens=short_new))
    if long_first:
        reqs = reqs[0::2] + reqs[1::2]
    return reqs


def prefix_requests(vocab, seed=SEED):
    """(c)'s traffic: 24 requests behind one SYSTEM_PROMPT-token system
    prompt, each with 8-40 seeded tokens of its own, 32 new tokens."""
    from flexflow_tpu_torch.serving import Request

    rng = np.random.default_rng(seed + 5)
    system = [int(t) for t in rng.integers(1, vocab, SYSTEM_PROMPT)]
    return [Request(rid=i, prompt=system + [int(t) for t in rng.integers(1, vocab, int(rng.integers(8, 41)))],
                    max_new_tokens=32) for i in range(24)]


def count_chunk_calls(sched, counter):
    """Count the engine's chunk steps (the scheduler's and those of
    prefill_suffix, all dispatched through prefill_chunk_dispatch) in
    counter["chunk_calls"]; track the peak of the shared table entries
    in counter["peak_shared"]."""
    engine = sched.engine
    chunk, end = engine.prefill_chunk_dispatch, sched._end_iteration

    def counted(*a, **kw):
        counter["chunk_calls"] += 1
        return chunk(*a, **kw)

    def ended():
        end()
        counter["peak_shared"] = max(counter["peak_shared"], sched.stats.prefix_pages_shared)

    engine.prefill_chunk_dispatch, sched._end_iteration = counted, ended


def feature_leg(name, model, layers, kernel, requests, plain=None, near_tie=None, lead=False, **serve_kw):
    """One 4e leg: every request FINISHED at full length, `kernel` launched
    (decode steps + chunk steps) x layers times and no other decode
    kernel; greedy streams held against `plain`, (streams, top) of the
    leg's baseline, as compare_streams does (NEAR_TIE, NEAR_TIE_INT8 on
    int8 pools). A baseline leg (plain=None) records its top two logits.
    `lead`: the first request arrives one iteration before the rest (a
    batch admitted together shares nothing among itself, and requests of
    equal length leave together: a lead staggers them, as arrivals are).
    Returns (streams, top, summary, stats)."""
    import torch

    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
    from flexflow_tpu_torch.serving import ServeConfig, build_scheduler, latency_percentiles

    counter = dict(chunk_calls=0, peak_shared=0)
    top = {} if plain is None else plain[1]
    cfg = dict(max_seqs=FLAGSHIP["max_seqs"], max_seq_len=FLAGSHIP["max_len"], **serve_kw)
    sched, _, cache = build_scheduler(model, ServeConfig(**cfg))
    count_chunk_calls(sched, counter)
    if plain is None and not serve_kw.get("temperature"):
        record_top2(sched, top)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dk.reset_launches()
    reqs = requests()
    t0 = time.perf_counter()
    if lead:
        sched.submit(reqs.pop(0))
        sched.step()
    done = sched.run(reqs)
    stats = sched.stats
    stats.elapsed_s = time.perf_counter() - t0
    launches = dict(dk.LAUNCHES)
    bad = [(r.rid, r.status, r.error, len(r.generated)) for r in done
           if not r.ok or len(r.generated) != r.max_new_tokens]
    require(len(done) == len(requests()) and not bad, f"{name}: requests not FINISHED at full length: {bad}")
    steps = stats.decode_steps + stats.verify_steps + counter["chunk_calls"]
    require(launches[kernel] == steps * layers,
            f"{name}: {kernel} launches {launches[kernel]} != ({stats.decode_steps} decode + "
            f"{stats.verify_steps} verify + {counter['chunk_calls']} chunk steps) x {layers} layers")
    others = {k: n for k, n in launches.items() if k != kernel and n}
    require(not others, f"{name}: other decode kernels launched: {others}")
    streams = {r.rid: list(r.generated) for r in done}
    ties = []
    if plain is not None:
        if near_tie is None:
            near_tie = NEAR_TIE_INT8 if serve_kw.get("kv_dtype") == "int8" else NEAR_TIE
        ties, _, _ = compare_streams(name, done, plain[0], top, {}, near_tie)
    short = [r for r in done if len(r.prompt) <= 6]
    ttft = latency_percentiles(done, (50, 95), metric="ttft")
    ttft_short = latency_percentiles(short, (50, 95), metric="ttft")
    summary = dict(
        leg=name, layers=layers, requests=len(done), tokens=stats.tokens_generated, elapsed_s=stats.elapsed_s,
        tokens_per_s=stats.tokens_per_s, ttft_p50_ms=1e3 * ttft[50], ttft_p95_ms=1e3 * ttft[95],
        short_ttft_p50_ms=1e3 * ttft_short[50] if short else None,
        short_ttft_p95_ms=1e3 * ttft_short[95] if short else None,
        decode_steps=stats.decode_steps, verify_steps=stats.verify_steps, chunk_steps=stats.chunk_steps,
        chunk_calls=counter["chunk_calls"], mean_decode_step_ms=1e3 * stats.mean_decode_step_s,
        chunk_s=stats.chunk_s, prefill_s=stats.prefill_s, budget_deferrals=stats.budget_deferrals,
        preemptions=stats.preemptions, peak_in_flight=stats.peak_in_flight, prefix_hits=stats.prefix_hits,
        peak_prefix_pages_shared=counter["peak_shared"], prefix_tokens_skipped=stats.prefix_tokens_skipped,
        cow_copies=stats.cow_copies, acceptance_rate=stats.acceptance_rate, kernel=kernel,
        launches=launches[kernel], near_ties=len(ties),
    )
    if getattr(cache, "paged", False):
        cache.check_invariants()
    print("[features] " + json.dumps(summary))
    return streams, top, summary, stats


def check_sampler_on_card(device="cuda"):
    """The sampler's words and tokens on the card equal the CPU's for
    fixed (seed, slot, position, logits) rows at the flagship's vocab."""
    import torch

    from flexflow_tpu_torch.serving import sampling

    rng = np.random.default_rng(SEED + 6)
    n, vocab = 64, FLAGSHIP["vocab"]
    slots = torch.from_numpy(rng.integers(0, FLAGSHIP["max_seqs"], n))
    pos = torch.from_numpy(rng.integers(0, FLAGSHIP["max_len"], n))
    logits = torch.from_numpy((3 * rng.standard_normal((n, vocab))).astype(np.float32))
    out = {}
    for dev in ("cpu", device):
        keys = sampling.row_keys(FEATURE_SEED, slots.to(dev), pos.to(dev))
        out[dev] = (sampling.random_bits(keys, vocab).cpu(), sampling.uniform(keys, vocab).cpu(),
                    sampling.sample(logits.to(dev), FEATURE_T, FEATURE_SEED, slots.to(dev), pos.to(dev)).cpu())
    require(torch.equal(out["cpu"][0], out[device][0]), "sampler: the card's random words differ from the CPU's")
    require(torch.equal(out["cpu"][1], out[device][1]), "sampler: the card's uniforms differ from the CPU's")
    same = int((out["cpu"][2] == out[device][2]).sum())
    require(same == n, f"sampler: {n - same} of {n} tokens differ between the card and the CPU")
    print(f"[features] sampler: {n} rows x {vocab} words and uniforms bit-equal on the card and the CPU; "
          f"{same} of {n} tokens equal")


def serve_features(device, layers=FLAGSHIP["layers"]):
    """Phase 4e on the fp32 flagship (see the module docstring)."""
    geo = dict(FLAGSHIP, layers=layers)
    vocab = geo["vocab"]
    model = build_lm(device, **geo)
    if device == "cuda":
        check_chunk_kernels(device)
    sampled = dict(temperature=FEATURE_T, seed=FEATURE_SEED)
    # (a) sampling
    burst = lambda: mixed_requests(vocab, geo["max_len"], NUM_REQUESTS)
    first, _, summary, _ = feature_leg("a: sampled burst", model, layers, "paged_flash_verify", burst, **sampled)
    again, _, _, _ = feature_leg("a: sampled burst, again", model, layers, "paged_flash_verify", burst, **sampled)
    require(first == again, "(a): two sampled runs with one seed gave different streams")
    fused, _, fsum, fstats = feature_leg("a: sampled burst, multistep", model, layers, "paged_flash_verify", burst,
                                         decode_multistep=True, **sampled)
    require(fused == first, "(a): sampled multi-step streams differ from eager")
    require(fstats.multistep_windows > 0, "(a): no fused window ran")
    spec = lambda: long_requests(vocab, geo["max_len"], SPEC_REQUESTS)
    _, _, ssum, _ = feature_leg("a: sampled linear spec", model, layers, "paged_flash_verify", spec,
                                **LINEAR, **sampled)
    if device == "cuda":
        check_sampler_on_card(device)
    # (b) chunked prefill, fp32 pools, int8 pools and the slot layout
    traffic = lambda: feature_requests(vocab)
    for leg, kernel, kw in (("fp32", "paged_flash_verify", {}),
                            ("int8", "paged_flash_verify_quant", dict(kv_dtype="int8")),
                            ("slot", "flash_verify", dict(kv_layout="slot"))):
        mono = feature_leg(f"b: {leg} monolithic", model, layers, kernel, traffic, **kw)
        _, _, _, cstats = feature_leg(f"b: {leg} chunked", model, layers, kernel, traffic, plain=mono[:2],
                                      **CHUNKED, **kw)
        require(cstats.chunk_steps > 0, f"(b) {leg}: no chunk step ran")
    # (c) prefix cache
    for leg, kernel, kw in (("fp32", "paged_flash_verify", {}),
                            ("int8", "paged_flash_verify_quant", dict(kv_dtype="int8"))):
        base = feature_leg(f"c: {leg} unshared", model, layers, kernel, lambda: prefix_requests(vocab), lead=True,
                           **kw)
        _, _, psum, _ = feature_leg(f"c: {leg} prefix cache", model, layers, kernel, lambda: prefix_requests(vocab),
                                    plain=base[:2], lead=True, prefix_cache=True, **kw)
        require(psum["prefix_hits"] > 0 and psum["peak_prefix_pages_shared"] > 0,
                f"(c) {leg}: no page was shared: {psum}")
    # (d) optimistic admission on half the pool
    heavy = lambda: feature_requests(vocab, long_first=True)
    reserve = feature_leg("d: reserve", model, layers, "paged_flash_verify", heavy, kv_pages=FEATURE_PAGES)
    _, _, osum, _ = feature_leg("d: optimistic", model, layers, "paged_flash_verify", heavy, plain=reserve[:2],
                                kv_pages=FEATURE_PAGES, admission="optimistic")
    require(osum["preemptions"] > 0, f"(d): optimistic admission preempted nothing: {osum}")


# -- 4f. the async double-buffered serving loop ----------------------------------------

# (c): 4e (b)'s interleaved traffic never runs a pool of 80-128 pages dry
# (the CPU rehearsal preempted nothing there); at 72 pages it preempts
# and every request still finishes inside the default bound of 3
ASYNC_PAGES_CHUNKED = 72
ASYNC_PAGES_PREFIX = 48  # (g): 768 rows, three max_len sequences: released published pages must be evicted


def check_dispatch_sync(model):
    """One chained decode dispatch, one multi-step window dispatch, one
    verify dispatch and one chunk dispatch under
    torch.cuda.set_sync_debug_mode("error"): none may wait for the
    stream. Each runs once first outside the mode (kernel builds, the
    graph's capture), and every step is reconciled outside it."""
    import torch

    from flexflow_tpu_torch.serving import ServeConfig, build_scheduler

    _, eng, cache = build_scheduler(model, ServeConfig(max_seqs=FLAGSHIP["max_seqs"], max_seq_len=FLAGSHIP["max_len"]))
    params, S = model.params, FLAGSHIP["max_seqs"]
    prompts = [[1 + j for j in range(12)], [20 + j for j in range(7)]]
    slots = [cache.alloc(len(p), FLAGSHIP["max_len"]) for p in prompts]
    first, _ = eng.prefill(params, prompts, slots)
    chunk_slot = cache.alloc(0, FLAGSHIP["max_len"])
    active = np.zeros(S, dtype=bool)
    active[slots] = True
    tokens = np.zeros(S, dtype=np.int32)
    tokens[slots] = first

    def halves():
        d1 = eng.decode_dispatch(params, tokens, active)
        d2 = eng.decode_dispatch(params, tokens, active, chain=d1, chain_mask=active)
        w = eng.decode_multi_dispatch(params, tokens, active, np.where(active, 3, 0))
        vt = np.zeros((S, 5), dtype=np.int32)
        vt[slots, 0] = tokens[slots]
        v = eng.verify_dispatch(params, vt, np.where(active, 5, 0))
        ct = np.zeros((S, 16), dtype=np.int32)
        ct[chunk_slot] = np.arange(1, 17)
        cl = np.zeros(S, dtype=np.int32)
        cl[chunk_slot] = 16
        return d1, d2, w, v, eng.prefill_chunk_dispatch(params, ct, cl)

    def reconcile(steps):
        d1, d2, w, v, c = steps
        eng.decode_reconcile(d1)
        eng.decode_reconcile(d2)
        eng.decode_multi_reconcile(w)
        eng.verify_reconcile(v)
        eng.prefill_chunk_reconcile(c)

    reconcile(halves())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        steps = halves()
    except RuntimeError as e:
        raise SystemExit(f"[async] a dispatch half waited for the stream: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    reconcile(steps)
    torch.cuda.synchronize()
    print("[async] chained decode, multi-step window, verify and chunk dispatches ran under "
          "set_sync_debug_mode('error') without a synchronizing call")


def record_verify_top2(sched, top):
    """Wrap a synchronous scheduler's verify commits so that top[rid]
    gains, for each token a verify emits, the record record_top2 keeps
    (the top two of the verify row that picked it)."""
    def wrap(commit):
        def recorded(step, logits):
            for slot, plan in (step.tree_plan or step.plan).items():
                req = step.participants[slot]
                if sched.running.get(slot) is not req:
                    continue
                recs = top.setdefault(req.rid, [])
                del recs[len(req.generated):]
                for r in rows_used(logits[slot], plan):
                    row = logits[slot, r]
                    second, first = np.argsort(row)[-2:]
                    recs.append((float(row[first] - row[second]), int(first), int(second), float(row[first])))
            return commit(step, logits)

        return recorded

    sched._commit_verify = wrap(sched._commit_verify)
    sched._commit_verify_tree = wrap(sched._commit_verify_tree)


def async_run(model, requests, serve_async, top=None, lead=False, **serve_kw):
    """One run of `requests()` on a fresh scheduler (the async one when
    `serve_async`): `top` records the run's top two logits per token
    (record_top2, record_verify_top2). Returns (finished, stats,
    launches, counter: chunk dispatches, drains that gave pages back,
    elapsed)."""
    import torch

    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
    from flexflow_tpu_torch.serving import ServeConfig, build_scheduler

    counter = dict(chunk_calls=0, peak_shared=0, drains=0)
    cfg = dict(max_seqs=FLAGSHIP["max_seqs"], max_seq_len=FLAGSHIP["max_len"], serve_async=serve_async, **serve_kw)
    sched, _, cache = build_scheduler(model, ServeConfig(**cfg))
    count_chunk_calls(sched, counter)
    reclaim = sched._reclaim_inflight_pages

    def counted_reclaim():
        drained = reclaim()
        counter["drains"] += int(drained)
        return drained

    sched._reclaim_inflight_pages = counted_reclaim
    if top is not None:
        record_top2(sched, top)
        record_verify_top2(sched, top)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dk.reset_launches()
    reqs = requests()
    t0 = time.perf_counter()
    if lead:
        sched.submit(reqs.pop(0))
        sched.step()
    done = sched.run(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    counter["elapsed_s"] = time.perf_counter() - t0
    if getattr(cache, "paged", False):
        cache.check_invariants()
    return done, sched.stats, dict(dk.LAUNCHES), counter


def async_summary(name, mode, layers, kernel, requests, done, stats, launches, counter):
    """Gates of one run: every request FINISHED at full length, `kernel`
    launched (decode + verify + chunk dispatches) x layers times (replays
    counted) and no other decode kernel. Returns its summary."""
    from flexflow_tpu_torch.serving import latency_percentiles

    bad = [(r.rid, r.status, r.error, len(r.generated)) for r in done
           if not r.ok or len(r.generated) != r.max_new_tokens]
    require(len(done) == len(requests()) and not bad, f"{name} {mode}: requests not FINISHED at full length: {bad}")
    steps = stats.decode_steps + stats.verify_steps + counter["chunk_calls"]
    require(launches[kernel] == steps * layers,
            f"{name} {mode}: {kernel} launches {launches[kernel]} != ({stats.decode_steps} decode + "
            f"{stats.verify_steps} verify + {counter['chunk_calls']} chunk steps) x {layers} layers")
    others = {k: n for k, n in launches.items() if k != kernel and n}
    require(not others, f"{name} {mode}: other decode kernels launched: {others}")
    ttft = latency_percentiles(done, (50, 95), metric="ttft")
    return dict(
        leg=name, mode=mode, layers=layers, tokens=stats.tokens_generated, elapsed_s=counter["elapsed_s"],
        tokens_per_s=stats.tokens_generated / counter["elapsed_s"], steps=steps,
        wall_ms_per_step=1e3 * counter["elapsed_s"] / steps, ttft_p50_ms=1e3 * ttft[50], ttft_p95_ms=1e3 * ttft[95],
        overlap_fraction=stats.overlap_fraction, mean_dispatch_gap_ms=1e3 * stats.mean_dispatch_gap_s,
        host_syncs_per_token=stats.host_syncs_per_token, dispatches=stats.dispatch_count,
        commit_wait_s=stats.commit_wait_s, preemptions=stats.preemptions, drains=counter["drains"],
        chunk_steps=stats.chunk_steps, windows=stats.multistep_windows, verify_steps=stats.verify_steps,
        acceptance_rate=stats.acceptance_rate, pre_proposal_hits=stats.pre_proposal_hits,
        pre_proposal_misses=stats.pre_proposal_misses, prefix_hits=stats.prefix_hits,
        prefix_evictions=stats.prefix_evictions, kernel=kernel, launches=launches[kernel],
    )


def async_leg(name, model, layers, kernel, requests, exact=True, near_tie=None, profile=None, lead=False,
              turns=("sync", "async"), **serve_kw):
    """A leg of phase 4f: the sync loop and the async one on fresh
    schedulers, in `turns`, none of them instrumented beyond counting.
    `exact`: the async streams equal the sync streams token for token;
    else (speculation, chunks, preemption, shared prefixes: a step may
    compute a row at another offset) they may part only at a near-tie of
    the sync run's top two logits, which one more sync run records where
    they part (compare_streams; NEAR_TIE, NEAR_TIE_INT8 on int8 pools).
    Runs of one loop give one stream. `profile`: iterations of a profiled
    window of busy slots per loop (device ms against wall ms). Prints one
    [async] line; returns (the sync streams, the sync top two or None,
    {mode: summary of its first run})."""
    runs, streams = {"sync": [], "async": []}, {}
    for mode in turns:
        done, stats, launches, counter = async_run(model, requests, mode == "async", lead=lead, **serve_kw)
        summary = async_summary(name, mode, layers, kernel, requests, done, stats, launches, counter)
        got = {r.rid: list(r.generated) for r in done}
        require(streams.setdefault(mode, got) == got, f"{name}: two {mode} runs gave different streams")
        runs[mode].append((summary, done))
    out = {mode: dict(runs[mode][0][0], tokens_per_s_turns=[r[0]["tokens_per_s"] for r in runs[mode]])
           for mode in runs}
    identical, top = streams["async"] == streams["sync"], None
    if exact:
        require(identical, f"{name}: the async streams differ from the sync streams")
    elif not identical:
        top = {}
        done, *_ = async_run(model, requests, False, top=top, lead=lead, **serve_kw)
        require({r.rid: list(r.generated) for r in done} == streams["sync"], f"{name}: the recorded sync run differs")
        if near_tie is None:
            near_tie = NEAR_TIE_INT8 if serve_kw.get("kv_dtype") == "int8" else NEAR_TIE
        ties, _, _ = compare_streams(name, runs["async"][0][1], streams["sync"], top, {}, near_tie)
        out["async"]["near_ties"] = len(ties)
    if profile and model.device.type == "cuda":
        for mode in ("sync", "async"):
            prof = profile_multistep(model, f"{name}, {mode}", profile, serve_async=mode == "async", **serve_kw)
            out[mode].update(profiled_device_ms_per_step=prof["device_ms_per_step"],
                             profiled_wall_ms_per_step=prof["wall_ms_per_step"], busy_share=prof["device_busy_share"])
    mean = lambda mode: float(np.mean(out[mode]["tokens_per_s_turns"]))
    line = dict(leg=name, sync=out["sync"], async_=out["async"], tokens_per_s_ratio=mean("async") / mean("sync"),
                identical=identical)
    print("[async] " + json.dumps(line).replace('"async_"', '"async"'))
    return streams["sync"], top, out


def serve_async_legs(device, layers=FLAGSHIP["layers"], small_layers=2):
    """Phase 4f (see the module docstring): each leg's async run beside
    its sync run on fresh schedulers, at full width; (a)-(c) at `layers`,
    (d)-(g) at `small_layers`."""
    vocab, max_len = FLAGSHIP["vocab"], FLAGSHIP["max_len"]
    model = build_lm(device, **dict(FLAGSHIP, layers=layers))
    if device == "cuda":
        check_dispatch_sync(model)
    burst = lambda: mixed_requests(vocab, max_len, NUM_REQUESTS)
    async_leg("a: burst, fp32 paged", model, layers, "paged_flash_verify", burst, profile=16,
              turns=("sync", "async", "async", "sync"))
    async_leg("b: sampled burst", model, layers, "paged_flash_verify", burst, temperature=FEATURE_T,
              seed=FEATURE_SEED)
    _, _, c = async_leg("c: chunked, int8, optimistic", model, layers, "paged_flash_verify_quant",
                        lambda: feature_requests(vocab), exact=False, kv_dtype="int8",
                        admission="optimistic", kv_pages=ASYNC_PAGES_CHUNKED, **CHUNKED)
    require(c["async"]["preemptions"] > 0, f"(c): the async loop preempted nothing: {c['async']}")
    del model
    small = build_lm(device, **dict(FLAGSHIP, layers=small_layers))
    long_ = lambda: long_requests(vocab, max_len, SPEC_REQUESTS)
    _, _, d = async_leg("d: linear spec, fp32 paged", small, small_layers, "paged_flash_verify", long_, exact=False,
                        **LINEAR)
    require(d["async"]["pre_proposal_hits"] + d["async"]["pre_proposal_misses"] > 0,
            "(d): the async loop drafted no pre-proposal")
    async_leg("d: tree spec, int8 paged", small, small_layers, "paged_flash_verify_tree_quant", long_, exact=False,
              kv_dtype="int8", **TREE)
    _, _, e = async_leg("e: multistep, fp32 paged", small, small_layers, "paged_flash_verify", long_, profile=4,
                        decode_multistep=True, max_fused_steps=MULTISTEP_STEPS)
    require(e["async"]["windows"] > 0, f"(e): no fused window ran: {e['async']}")
    async_leg("f: plain, slot", small, small_layers, "flash_verify", long_, kv_layout="slot")
    async_leg("f: tree spec, slot", small, small_layers, "flash_verify_tree", long_, exact=False, kv_layout="slot",
              **TREE)
    shared = lambda: prefix_requests(vocab)
    lru = dict(lead=True, prefix_cache=True, kv_pages=ASYNC_PAGES_PREFIX)
    lru_streams, _, g = async_leg("g: prefix cache, lru", small, small_layers, "paged_flash_verify", shared,
                                  exact=False, prefix_evict="lru", **lru)
    require(min(g["sync"]["prefix_evictions"], g["async"]["prefix_evictions"]) > 0,
            f"(g): no published page was evicted: {g}")
    done, stats, launches, counter = async_run(small, shared, False, **lru)
    none = async_summary("g: prefix cache, none", "sync", small_layers, "paged_flash_verify", shared, done, stats,
                         launches, counter)
    if {r.rid: list(r.generated) for r in done} != lru_streams:
        top = {}
        async_run(small, shared, False, top=top, prefix_evict="lru", **lru)
        none["near_ties"] = len(compare_streams("g: none against lru", done, lru_streams, top, {}, NEAR_TIE)[0])
    print("[async] " + json.dumps(dict(leg="g: prefix_evict none beside lru", none=none,
                                       lru_evictions=g["sync"]["prefix_evictions"])))


# -- 4g. multi-tenant serving and the small-model draft --------------------------------

TENANT = dict(adapters=2, adapter_rank=8)  # two resident adapters of rank 8 (seeds 0 and 1)
TENANT_CLASSES = "gold:4,bronze:1"
# (c)'s int8 optimistic leg: 8 slots of at most 13 pages never run a pool
# of 80-128 pages dry on this traffic; 72 preempts (twice, by the page
# ledger alone, which is the same at any width)
TENANT_PAGES = 72
DRAFT_LAYERS = 2  # the small draft LM of (d), at the flagship's full width


def load_adapters(engine):
    """Load adapters 0 and 1 (rank 8, seeds 0 and 1) into the engine's
    pool, if it has one."""
    from flexflow_tpu_torch.serving import make_lora_weights

    if engine.adapters is not None:
        for aid in (0, 1):
            engine.adapters.load(aid, make_lora_weights(engine.adapters.spec, 8, seed=aid))


def with_adapters(requests, adapters):
    """`requests()` with request i on adapters[i % len(adapters)] (-1:
    the base model)."""
    def make():
        reqs = requests()
        for i, r in enumerate(reqs):
            r.adapter_id = adapters[i % len(adapters)]
        return reqs

    return make


def tenant_requests(vocab, classes=True, seed=SEED):
    """(c)'s traffic: 32 requests of 4 + U[0, 128) seeded prompt tokens and
    64 new tokens, gold / bronze alternating (`classes`), adapters
    rotating 0 / 1 / none, all submitted at once."""
    from flexflow_tpu_torch.serving import Request

    rng = np.random.default_rng(seed + 7)
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(1, vocab, 4 + int(rng.integers(0, 128)))],
                    max_new_tokens=64, priority_class=("gold" if i % 2 == 0 else "bronze") if classes else "",
                    adapter_id=(0, 1, -1)[i % 3]) for i in range(32)]


def record_rejections(sched, gaps):
    """Wrap a linear speculative scheduler's verify commits so that `gaps`
    gains, for each draft token the target rejects, the gap between the
    target's top logit and the rejected token's on the verify row."""
    from flexflow_tpu_torch.serving import accept_drafts

    commit = sched._commit_verify

    def recorded(step, logits):
        for slot, drafts in step.plan.items():
            if sched.running.get(slot) is not step.participants[slot]:
                continue
            accepted, _ = accept_drafts(logits[slot], drafts)
            if accepted < len(drafts):
                row = logits[slot, accepted]
                gaps.append(float(row.max() - row[drafts[accepted]]))
        return commit(step, logits)

    sched._commit_verify = recorded


def tenant_leg(name, model, layers, kernel, requests, plain=None, near_tie=None, record=False, draft=None,
               rejections=None, **serve_kw):
    """One 4g leg on a fresh scheduler (with `adapters` in `serve_kw`,
    adapters 0 and 1 load first); `draft` is the (draft model, its
    layers) of spec_draft="model". Every request
    FINISHED at full length; `kernel` launched (decode + verify + chunk
    steps) x layers times (replays counted), the draft's #4 draft steps x
    its layers, and no other decode kernel. `record` keeps the run's top
    two logits per token (a baseline); `plain`, (streams, top) of a
    baseline, holds the streams to it as compare_streams does (NEAR_TIE,
    NEAR_TIE_INT8 on int8 pools); `rejections`, a list, takes the gap
    of each rejected draft token (record_rejections). Prints one
    [tenancy] line; returns (streams, top, summary, finished requests)."""
    import torch

    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
    from flexflow_tpu_torch.serving import ServeConfig, build_scheduler, latency_percentiles

    counter = dict(chunk_calls=0, peak_shared=0)
    cfg = dict(max_seqs=FLAGSHIP["max_seqs"], max_seq_len=FLAGSHIP["max_len"], **serve_kw)
    sched, engine, cache = build_scheduler(model, ServeConfig(**cfg), draft_model=draft[0] if draft else None)
    load_adapters(engine)
    count_chunk_calls(sched, counter)
    top = {} if record else (plain[1] if plain else None)
    if record:
        record_top2(sched, top)
    if rejections is not None:
        record_rejections(sched, rejections)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dk.reset_launches()
    reqs = requests()
    t0 = time.perf_counter()
    done = sched.run(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(dk.LAUNCHES)
    stats = sched.stats
    bad = [(r.rid, r.status, r.error, len(r.generated)) for r in done
           if not r.ok or len(r.generated) != r.max_new_tokens]
    require(len(done) == len(reqs) and not bad, f"{name}: requests not FINISHED at full length: {bad}")
    steps = stats.decode_steps + stats.verify_steps + counter["chunk_calls"]
    require(launches[kernel] == steps * layers,
            f"{name}: {kernel} launches {launches[kernel]} != ({stats.decode_steps} decode + {stats.verify_steps} "
            f"verify + {counter['chunk_calls']} chunk steps) x {layers} layers")
    want = {kernel}
    proposer = sched.proposer if draft else None
    if draft:
        require(kernel != "flash_verify", f"{name}: the target and the draft both run #4")
        require(launches["flash_verify"] == proposer.draft_steps * draft[1] > 0,
                f"{name}: the draft's flash_verify launches {launches['flash_verify']} != "
                f"{proposer.draft_steps} draft steps x {draft[1]} layers")
        want.add("flash_verify")
    others = {k: n for k, n in launches.items() if k not in want and n}
    require(not others, f"{name}: other decode kernels launched: {others}")
    streams = {r.rid: list(r.generated) for r in done}
    ties = []
    if plain is not None:
        if near_tie is None:
            near_tie = NEAR_TIE_INT8 if serve_kw.get("kv_dtype") == "int8" else NEAR_TIE
        ties, _, _ = compare_streams(name, done, plain[0], top, {}, near_tie)
    if getattr(cache, "paged", False):
        cache.check_invariants()
    if engine.adapters is not None:
        engine.adapters.check_invariants()
    ttft = latency_percentiles(done, (50, 95), metric="ttft")
    summary = dict(
        leg=name, layers=layers, requests=len(done), tokens=stats.tokens_generated, elapsed_s=elapsed,
        tokens_per_s=stats.tokens_generated / elapsed, steps=steps, wall_ms_per_step=1e3 * elapsed / steps,
        ttft_p50_ms=1e3 * ttft[50], ttft_p95_ms=1e3 * ttft[95], decode_steps=stats.decode_steps,
        verify_steps=stats.verify_steps, chunk_steps=stats.chunk_steps, windows=stats.multistep_windows,
        preemptions=stats.preemptions, acceptance_rate=stats.acceptance_rate, kernel=kernel,
        launches=launches[kernel], near_ties=len(ties),
    )
    if draft:
        summary.update(draft_steps=proposer.draft_steps, catchup_feeds=proposer.catchup_feeds,
                       draft_tokens=proposer.draft_tokens, draft_launches=launches["flash_verify"])
    if rejections is not None:
        summary.update(rejections=len(rejections), max_rejection_gap=max(rejections, default=0.0))
    print("[tenancy] " + json.dumps(summary))
    return streams, top, summary, done


def adapter_bite(model):
    """The first-step logits of one prompt prefilled into three slots on
    adapters 0, 1 and none: each adapter row's largest |change| from the
    base row."""
    from flexflow_tpu_torch.serving import ServeConfig, build_scheduler

    _, eng, cache = build_scheduler(model, ServeConfig(max_seqs=FLAGSHIP["max_seqs"], max_seq_len=FLAGSHIP["max_len"],
                                                       **TENANT))
    load_adapters(eng)
    prompt = [(7 * j + 3) % FLAGSHIP["vocab"] for j in range(6)]
    slots = [cache.alloc(len(prompt), 64) for _ in range(3)]
    eng.adapters.attach(slots[0], 0)
    eng.adapters.attach(slots[1], 1)
    _, last = eng.prefill(model.params, [prompt] * 3, slots)
    last = last.float()
    return {f"adapter_{aid}": float((last[aid] - last[2]).abs().max()) for aid in (0, 1)}


def serve_tenancy(device, burst, layers=FLAGSHIP["layers"], draft_layers=DRAFT_LAYERS):
    """Phase 4g on the fp32 flagship (see the module docstring): `burst` is
    phase 3's streams."""
    t_phase = time.perf_counter()
    geo = dict(FLAGSHIP, layers=layers)
    vocab = geo["vocab"]
    model = build_lm(device, **geo)
    burst_reqs = lambda: mixed_requests(vocab, geo["max_len"], NUM_REQUESTS)
    kernel, quant = "paged_flash_verify", "paged_flash_verify_quant"
    # (a) identity: a loaded pool serving only the base model, beside no pool
    nopool, top, npsum, _ = tenant_leg("a: no pool", model, layers, kernel, burst_reqs, record=True)
    require(nopool == burst, "(a): the burst without a pool differs from phase 3's streams")
    base = (nopool, top)
    ident, _, isum, _ = tenant_leg("a: identity, eager", model, layers, kernel, burst_reqs, **TENANT)
    require(ident == burst, "(a): a pool serving the base model changed phase 3's streams")
    if device == "cuda":
        # a pool's rows all compute their deltas (base rows gather the
        # zero sentinel and are selected away): the device work of
        # adapter rows at the same shapes
        prof = {}
        for tag, kw in (("no pool", {}), ("pool", TENANT)):
            for mode, mkw in (("eager", {}), ("windows", dict(decode_multistep=True, max_fused_steps=MULTISTEP_STEPS))):
                prof[tag, mode] = profile_multistep(model, f"4g: {tag}, {mode}", 16 if mode == "eager" else 4,
                                                    **kw, **mkw)
        added = {}
        for mode in ("eager", "windows"):
            a, b = prof["pool", mode], prof["no pool", mode]
            added[mode] = dict(
                wall_ms_per_step=[b["wall_ms_per_step"], a["wall_ms_per_step"]],
                wall_ratio=a["wall_ms_per_step"] / b["wall_ms_per_step"],
                device_ms_added_per_step=(a["device_ms_per_step"] - b["device_ms_per_step"]
                                          if a["device_ms_per_step"] and b["device_ms_per_step"] else None),
                device_ops_added_per_step=a["device_ops_per_step"] - b["device_ops_per_step"],
            )
        print("[tenancy] " + json.dumps(dict(leg="a: what a pool adds a decode step (no pool, pool)", **added)))
    fused, _, fsum, _ = tenant_leg("a: identity, multistep", model, layers, kernel, burst_reqs,
                                   decode_multistep=True, **TENANT)
    require(fused == burst and fsum["windows"] > 0, "(a): multistep streams differ from phase 3's, or no window ran")
    asyn, _, _, _ = tenant_leg("a: identity, async", model, layers, kernel, burst_reqs, serve_async=True,
                               **TENANT)
    require(asyn == burst, "(a): async streams differ from phase 3's")
    # (b) mixed adapters, each stream against its adapter's batch alone
    mixed, _, msum, _ = tenant_leg("b: adapters 0 / 1 / none", model, layers, kernel,
                                   with_adapters(burst_reqs, (0, 1, -1)), **TENANT)
    for aid in (0, 1):
        alone, _, _, _ = tenant_leg(f"b: every request on adapter {aid}", model, layers, kernel,
                                    with_adapters(burst_reqs, (aid,)), **TENANT)
        bad = [rid for rid in mixed if rid % 3 == aid and mixed[rid] != alone[rid]]
        require(not bad, f"(b): requests {bad} on adapter {aid} differ from their adapter's batch alone")
    bad = [rid for rid in mixed if rid % 3 == 2 and mixed[rid] != burst[rid]]
    require(not bad, f"(b): base-model requests {bad} differ from phase 3's streams")
    moved = sum(1 for rid in mixed if rid % 3 != 2 and mixed[rid] != burst[rid])
    bite = adapter_bite(model)
    require(min(bite.values()) > 1e-3, f"(b): an adapter moved the first logits by no more than 1e-3: {bite}")
    print("[tenancy] " + json.dumps(dict(
        leg="b: isolation", first_logit_change=bite, adapter_streams_unlike_base=moved,
        wall_ms_per_step=dict(no_pool=npsum["wall_ms_per_step"], identity=isum["wall_ms_per_step"],
                              mixed=msum["wall_ms_per_step"]))))
    # (c) weighted fairness under a token budget, beside the same traffic without classes
    fifo, ftop, _, _ = tenant_leg("c: no classes", model, layers, kernel, lambda: tenant_requests(vocab, False),
                                  record=True, **CHUNKED, **TENANT)
    _, _, csum, done = tenant_leg("c: gold:4,bronze:1", model, layers, kernel, lambda: tenant_requests(vocab),
                                  plain=(fifo, ftop), classes=TENANT_CLASSES, **CHUNKED, **TENANT)
    by_class = {c: [r for r in done if r.priority_class == c] for c in ("gold", "bronze")}
    require(all(r.ok for r in by_class["bronze"]) and len(by_class["bronze"]) == 16, "(c): a bronze request starved")
    admit = {c: float(np.mean([r.admit_iter for r in rs])) for c, rs in by_class.items()}
    require(admit["gold"] < admit["bronze"], f"(c): gold was not admitted ahead of bronze: {admit}")
    from flexflow_tpu_torch.serving import latency_percentiles

    ttft = {c: {p: 1e3 * v for p, v in latency_percentiles(rs, (50, 95), metric="ttft").items()}
            for c, rs in by_class.items()}
    print("[tenancy] " + json.dumps(dict(leg="c: per class", mean_admit_iteration=admit, ttft_ms=ttft)))
    int8 = tenant_leg("c: int8, reserve", model, layers, quant, lambda: tenant_requests(vocab),
                      record=True, kv_dtype="int8", classes=TENANT_CLASSES, **CHUNKED, **TENANT)
    victims = []
    from flexflow_tpu_torch.serving.scheduler import _SchedulerBase

    real = _SchedulerBase._preempt

    def spy(self, req, *a, **kw):
        victims.append(req.priority_class)
        return real(self, req, *a, **kw)

    _SchedulerBase._preempt = spy
    try:
        _, _, osum, _ = tenant_leg("c: int8, optimistic", model, layers, quant, lambda: tenant_requests(vocab),
                                   plain=int8[:2], kv_dtype="int8", classes=TENANT_CLASSES,
                                   admission="optimistic", kv_pages=TENANT_PAGES, **CHUNKED, **TENANT)
    finally:
        _SchedulerBase._preempt = real
    require(osum["preemptions"] > 0, f"(c): optimistic admission on {TENANT_PAGES} pages preempted nothing")
    print("[tenancy] " + json.dumps(dict(leg="c: victims", classes=victims,
                                         gold=victims.count("gold"), bronze=victims.count("bronze"))))
    # (d) the small-model draft: the target as its own draft, then a 2-layer draft
    gaps = []
    _, _, ssum, _ = tenant_leg("d: self-draft, fp32 paged", model, layers, kernel, burst_reqs, plain=base,
                               draft=(model, layers), rejections=gaps, spec_draft="model", spec_k=4)
    require(all(g <= NEAR_TIE for g in gaps),
            f"(d): the self-draft was rejected off a near-tie: {max(gaps, default=0.0)}")
    require(gaps or ssum["acceptance_rate"] == 1.0, f"(d): self-draft acceptance {ssum['acceptance_rate']}")
    small = build_lm(device, **dict(FLAGSHIP, layers=draft_layers, seed=SEED + 1))
    spec = dict(spec_draft="model", spec_k=4)
    lin, _, _, _ = tenant_leg("d: 2-layer draft, linear, fp32 paged", model, layers, kernel, burst_reqs, plain=base,
                              draft=(small, draft_layers), **spec)
    plain8 = tenant_leg("d: plain, int8 paged", model, layers, quant, burst_reqs, record=True, kv_dtype="int8")
    tenant_leg("d: 2-layer draft, tree, int8 paged", model, layers, "paged_flash_verify_tree_quant", burst_reqs,
               plain=plain8[:2], draft=(small, draft_layers), kv_dtype="int8", spec_branch=3, **spec)
    _, _, _, adone = tenant_leg("d: 2-layer draft, linear, async", model, layers, kernel, burst_reqs,
                                draft=(small, draft_layers), serve_async=True, **spec)
    if {r.rid: list(r.generated) for r in adone} != lin:
        compare_streams("d: async against phase 3", adone, burst, top, {}, NEAR_TIE)
    print(f"[tenancy] phase 4g: {time.perf_counter() - t_phase:.1f} s")


def flash_inputs(device, b, sq, sk, h, d, causal, seed=SEED, dtype=None):
    """Seeded q, k, v, dO (float32, or `dtype`) and the plain forward's
    (O, LSE) and delta (summed in float32)."""
    import torch

    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    g = torch.Generator().manual_seed(seed + 7 * sq + sk + d + int(causal))
    q, k, v = (torch.randn(b, s, h, d, generator=g).to(device, dtype) for s in (sq, sk, sk))
    do = torch.randn(b, sq, h, d, generator=g).to(device, dtype)
    o, lse = fk.flash_fwd_ref(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return dict(q=q, k=k, v=v, do=do, o=o, lse=lse, delta=delta, causal=causal)


def flash_base(name):
    """The kernel (flash_fwd, flash_dq, flash_dkv) a LAUNCHES name counts."""
    return name.replace("_wide", "").replace("_bf16", "")


def flash_calls(x):
    """{kernel: (kernel call, plain call)} on the inputs x (the LAUNCHES
    names of the bodies their dtype and head_dim run)."""
    import torch

    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    fwd = (x["q"], x["k"], x["v"], x["causal"])
    bwd = (x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"], x["causal"])
    d = x["q"].shape[-1]
    if x["q"].dtype == torch.bfloat16:
        suffix = "_wide_bf16" if d > 256 else "_bf16"
    else:
        suffix = "_wide" if d > 128 else ""
    return {
        "flash_fwd" + suffix: (lambda: fk.flash_fwd(*fwd), lambda: fk.flash_fwd_ref(*fwd)),
        "flash_dq" + suffix: (lambda: fk.flash_dq(*bwd), lambda: fk.flash_dq_ref(*bwd)),
        "flash_dkv" + suffix: (lambda: fk.flash_dkv(*bwd), lambda: fk.flash_dkv_ref(*bwd)),
    }


def flash_bound_ms(x, name):
    """Least time on these inputs: every operand read once and every
    output written once at 3.35 TB/s, against the kernel's products over
    the visible (query, key) pairs (2 forward, 3 for dQ, 4 for dK/dV). The
    fp32 bodies at their fp32-accurate rate on this card: 3 TF32 passes of
    2 flops per multiply-add at 495 TFLOP/s (3xTF32 on the dense tensor
    cores, 700 W), an effective 165 TFLOP/s, above the 67 TFLOP/s of fp32
    FMAs; the bf16 bodies one pass at the data sheet's 989 TFLOP/s of
    dense bf16, their q, k, v, dO and outputs 2 bytes an element (LSE
    and delta 4)."""
    import torch

    b, sq, h, d = x["q"].shape
    sk = x["k"].shape[1]
    pairs = b * h * (sum(min(i + 1, sk) for i in range(sq)) if x["causal"] else sq * sk)
    qo, kv, rows = b * sq * h * d, b * sk * h * d, b * h * sq
    bf16 = x["q"].dtype == torch.bfloat16
    base = flash_base(name)
    el = 2 if bf16 else 4
    nbytes = {
        "flash_fwd": el * (2 * qo + 2 * kv) + 4 * rows,       # q, k, v in; O, LSE out
        "flash_dq": el * (3 * qo + 2 * kv) + 4 * 2 * rows,    # q, dO, k, v, lse, delta in; dQ out
        "flash_dkv": el * (2 * qo + 4 * kv) + 4 * 2 * rows,   # q, dO, k, v, lse, delta in; dK, dV out
    }[base]
    flops = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}[base] * pairs * d
    rate = BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S / TF32_PASSES
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sass_opcodes(source, kernel=None):
    """{opcode: count} over the SASS of the library built from
    csrc/<source> (cuobjdump beside nvcc), or with `kernel` (a regular
    expression) {mangled name: {opcode: count}} of the kernels whose name
    it matches; None without cuobjdump."""
    import collections
    import re

    from flexflow_tpu_torch.ops.cuda import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    res = subprocess.run([tool, "-sass", _build.library_path(source)], capture_output=True, text=True,
                         timeout=120, check=True)
    fn, per = None, collections.defaultdict(collections.Counter)
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.match(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and fn:
            per[fn][m.group(1)] += 1
    if kernel is not None:
        return {f: ops for f, ops in per.items() if re.search(kernel, f)}
    return sum(per.values(), collections.Counter())


def flash_resources(dims=(64, 128, 136, 256, 264, 320, 512, 520, 1032, 1224)):
    """Each flash kernel's ptxas report (registers, spills) at the
    instantiation of each head_dim of `dims` (past 128 the wide bodies:
    #1's with Q resident up to 1216 and streamed past it, #2 and #3's
    with the fixed tile resident up to 512 and streamed past it, past 256
    also #2 and #3's bf16 body; bf16 #1's wide body past 256 by the card's
    own count of registers and spills), its shared memory and blocks per
    SM on this card, and the tensor-core (HMMA, HGMMA) instructions of
    each flash library's SASS. Fails where fp32 #2 or #3 holds local
    memory (spills) at any head_dim of `dims`, where ptxas serialized any
    tensor-core instruction of the backward, where the SASS of the wide
    kernels holds no TMA load (UTMALDG) or a cp.async copy (LDGSTS), or
    where that of the tf32 bodies (up to head_dim 128) holds no wgmma
    (HGMMA) or TMA load, or a cp.async copy."""
    from flexflow_tpu_torch.ops.cuda import _build
    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    def ptxas(source, sym, tag):
        log = _build.build_logs.get(source, "").splitlines()
        info = []
        for i, line in enumerate(log):
            if "Compiling entry function" in line and sym in line and tag in line:
                info = [x.strip() for x in log[i + 1 : i + 4] if "registers" in x or "spill" in x]
        return "; ".join(info) or "not in the build log"

    for d in dims:
        kdt = 4 << (0 if d <= 32 else 1 if d <= 64 else 2 if d <= 128 else 3)  # the source's bucket
        names = FLASH_WIDE_FP32 if d > 128 else FLASH_FP32
        if d > 256:
            names += ("flash_fwd_wide_bf16", "flash_dq_wide_bf16", "flash_dkv_wide_bf16")
        for name in names:
            base = flash_base(name)
            if name == "flash_fwd_wide_bf16":  # registers and spills as the card reports them
                print(f"[resources] {name} at head_dim {d} (flash_fwd_wide_bf16_wgmma_kernel): "
                      + json.dumps(fk.occupancy(name, d)))
                continue
            source = fk.SOURCE if base == "flash_fwd" else fk.BWD_SOURCE
            if d <= 128 and (base == "flash_fwd" or (base == "flash_dkv" and d > 64)):
                # #1, and #3 at 72-128: the 3xTF32 mma.sync bodies
                sym, tag, label = f"{base}_mma_kernel", f"ILi{kdt}E", f"{base}_mma_kernel<{kdt}>"
            elif d <= 128:  # #2 and #3's tf32 bodies: Tf32Cfg<boxes, ...> of the bucket
                sym, tag = f"{base}_tf32_kernel", f"Tf32CfgILi{kdt // 4}E"
                label = f"{sym}<{'Dq' if base == 'flash_dq' else 'Dkv'}B{kdt // 8}>"
            elif name.endswith("_bf16"):  # #2 and #3's bf16 body past 256
                sym = label = tag = f"{base}_wide_bf16_kernel"
            else:  # the template argument: Q (#1) or the fixed tile (#2, #3) resident or streamed
                resident = d <= (1216 if base == "flash_fwd" else 512)
                sym, tag = f"{base}_wide_kernel", "ILb1E" if resident else "ILb0E"
                label = f"{sym}<{'true' if resident else 'false'}>"
            occ = fk.occupancy(name, d)
            print(f"[resources] {name} at head_dim {d} ({label}): " + json.dumps(occ)
                  + f"; ptxas: {ptxas(source, sym, tag)}")
            if name in ("flash_dq_wide", "flash_dkv_wide", "flash_dq", "flash_dkv"):
                require(occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1,
                        f"{name} at head_dim {d} ({label}) spills or does not fit: {occ}")
    serialized = [line.strip() for line in _build.build_logs.get(fk.BWD_SOURCE, "").splitlines()
                  if "serialized" in line]
    require(not serialized, f"ptxas serialized tensor-core instructions of {fk.BWD_SOURCE}: {serialized}")
    for source in (fk.SOURCE, fk.BWD_SOURCE):
        ops = sass_opcodes(source)
        if ops is None:
            print(f"[resources] {source}: cuobjdump not found, SASS not read")
            continue
        print(f"[resources] {source}: {ops.get('HMMA', 0)} HMMA instructions in its SASS; top opcodes "
              + json.dumps(ops.most_common(14)))
    wide = sass_opcodes(fk.BWD_SOURCE, r"flash_(dq|dkv)_wide_kernelILb[01]E")
    require(wide is not None and len(wide) == 4, f"{fk.BWD_SOURCE}: the fp32 wide kernels' SASS not read")
    for fn, ops in sorted(wide.items()):
        counts = {op: ops.get(op, 0) for op in ("UTMALDG", "LDGSTS", "HMMA")}
        print(f"[resources] {fn}: " + json.dumps(counts))
        require(counts["UTMALDG"] > 0 and counts["LDGSTS"] == 0, f"{fn}: TMA loads and cp.async copies {counts}")
    # #2 and #3's tf32 bodies (head_dim up to 128; #3 up to 64): every
    # product on .tf32 wgmma (HGMMA), loads by TMA alone
    tf32 = sass_opcodes(fk.BWD_SOURCE, r"flash_(dq|dkv)_tf32_kernel")
    require(tf32 is not None and any("dq_tf32" in f for f in tf32) and any("dkv_tf32" in f for f in tf32),
            f"{fk.BWD_SOURCE}: the tf32 bodies' SASS not read")
    for fn, ops in sorted(tf32.items()):
        counts = {op: ops.get(op, 0) for op in ("HGMMA", "HMMA", "UTMALDG", "LDGSTS")}
        print(f"[resources] {fn}: " + json.dumps(counts))
        require(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0 and counts["LDGSTS"] == 0,
                f"{fn}: wgmma products and TMA loads {counts}")


def check_flash_case(x, tag):
    """#1-#3 on the inputs x against their plain versions at the
    reference's scale (O and LSE 2e-5; dQ, dK, dV atol 5e-5, rtol 5e-4);
    returns {kernel: max |kernel - plain|}."""
    import torch

    errs = {}
    for name, (kernel, plain) in flash_calls(x).items():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a - r).abs().max()) for a, r in zip(got, want))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        if flash_base(name) == "flash_fwd":
            ok = err <= ATOL_FLASH_FWD
        else:
            ok = all(torch.allclose(a, r, atol=ATOL_FLASH_GRAD, rtol=RTOL_FLASH_GRAD) for a, r in zip(got, want))
        print(f"[kernels] {name} {tag}: max |kernel - plain| = {err:.3e}")
        require(finite and ok, f"{name} {tag}: error {err}")
        errs[name] = err
    return errs


# The timed shapes of phase 5: the flagship shape, causal and not (its
# non-causal times go into the kernels line), then the wide bodies (past
# head_dim 128): 4 heads of 320 (the fp32 wide kernels' rows of the
# kernels line), the flagship's width in 4 heads of 256, 2 heads of 512
# at half the length, and 4 heads of 320 causal. The flagship's are timed
# before any wide kernel or correctness case runs: once those have run,
# the profiler's sessions on the card read only part of their kernels
# (measured: 19 of 20 flushes, then device times of half the event
# timer's).
FLASH_TIMED = ((TRAIN["seq"], TRAIN["heads"], TRAIN["hidden"] // TRAIN["heads"], False),
               (TRAIN["seq"], TRAIN["heads"], TRAIN["hidden"] // TRAIN["heads"], True))
FLASH_TIMED_WIDE = ((TRAIN["seq"], 4, 320, False), (TRAIN["seq"], TRAIN["hidden"] // 256, 256, False),
                    (TRAIN["seq"] // 2, 2, 512, False), (TRAIN["seq"], 4, 320, True))
# the bf16 wide bodies (past head_dim 256) at those shapes
FLASH_TIMED_WIDE_BF16 = tuple(x for x in FLASH_TIMED_WIDE if x[2] > 256)
# the bf16 bodies also at the flagship's width in heads of 128 and 256
# (bf16 #1's wgmma body at its other head_dim buckets), timed with the
# flagship's before any wide kernel runs
FLASH_TIMED_BF16 = ((TRAIN["seq"], TRAIN["hidden"] // 128, 128, False),
                    (TRAIN["seq"], TRAIN["hidden"] // 256, 256, False))


def time_flash_kernels(shapes):
    """Times of #1-#3 at `shapes` ((seq, heads, head_dim, causal) at the
    flagship's batch) by the event timer and by the profiler's device
    time, beside SDPA's and the port's dense core; past head_dim 128 (the
    wide bodies, which stream the score contraction over head_dim) the
    reference's gate at the timed shape itself. Returns the kernels-line
    rows of each kernel's first non-causal shape."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops import attention as attn

    device = torch.device("cuda")
    b, d = TRAIN["batch"], TRAIN["hidden"] // TRAIN["heads"]
    rows = {}
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    flush = lambda: flush_buf.zero_()
    for ts, th, td, causal in shapes:
        x = flash_inputs(device, b, ts, ts, th, td, causal)
        flagship = td == d
        tag = ("causal" if causal else "non-causal") + ("" if flagship else f" [{b}, {ts}, {th}, {td}]")
        if td > 128:  # the reference's gate at the timed shape itself
            check_flash_case(x, tag)
        dev, timer, first = {}, {}, []
        for name, (kernel, plain) in flash_calls(x).items():
            ms, plain_ms = time_ms(kernel, flush), time_ms(plain, flush)
            base = flash_base(name)
            dev[base], timer[base] = device_ms(kernel, flush), ms
            bound, by = flash_bound_ms(x, name)
            print(f"[kernels] {name} {tag}: {ms:.4f} ms, device {dev[base]} ms (bound {bound:.4f} ms, {by}), "
                  f"plain {plain_ms:.4f} ms")
            if not causal and name not in rows:
                rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
                first.append(name)
        # yardsticks, timed only: PyTorch's SDPA and the port's dense core
        qt, kt, vt, dot = (x[n].transpose(1, 2).contiguous().requires_grad_(n != "do") for n in ("q", "k", "v", "do"))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        out = sdpa()
        sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        lib_fwd, lib_bwd = time_ms(sdpa, flush), time_ms(sdpa_bwd, flush)
        (lib_fwd_dev, fwd_backend), (lib_bwd_dev, bwd_backend) = (
            device_ms(sdpa, flush, top=True), device_ms(sdpa_bwd, flush, top=True)
        )
        qd, kd, vd = (x[n].detach().clone().requires_grad_(True) for n in ("q", "k", "v"))

        def dense():
            o = attn.scaled_dot_product_attention(qd, kd, vd, causal=causal)
            return torch.autograd.grad(o, (qd, kd, vd), x["do"])

        dense_ms = time_ms(dense, flush)
        print(f"[kernels] {tag}: #1 forward {timer['flash_fwd']:.4f} ms, device {dev['flash_fwd']} ms; "
              f"SDPA forward {lib_fwd:.4f} ms, device {lib_fwd_dev} ms")
        pair = None if None in (dev["flash_dq"], dev["flash_dkv"]) else dev["flash_dq"] + dev["flash_dkv"]
        print(f"[kernels] {tag}: library SDPA forward {lib_fwd:.4f} ms, device {lib_fwd_dev} ms "
              f"({fwd_backend}), backward (#2 + #3) {lib_bwd:.4f} ms, device {lib_bwd_dev} ms "
              f"({bwd_backend}); #2 + #3 device {pair} ms; the port's dense core forward + "
              f"backward {dense_ms:.4f} ms")
        for name in first:
            rows[name]["library_ms"] = lib_fwd if flash_base(name) == "flash_fwd" else lib_bwd
        if flagship and not causal:
            rows["dense_ms"] = dense_ms
        del out
    return rows


def check_flash_kernels(rows):
    """Kernels #1-#3 against their plain versions at the reference's scale,
    at the flagship training shape, causal and not, ragged shapes (sq !=
    sk both ways, head_dim 24 to 1032) and the reference's test shapes,
    each kernel's worst error into `rows` (past 128 the wide bodies'
    rows), #1's wide body also at its edges (a ragged last piece at 136,
    248, one visible key, one query tile and one row past it, the widest
    resident Q at 1216 and the first streamed one at 1224), #2 and #3's at
    theirs (136, one visible key, the first streamed fixed tile at 520);
    the kernels' resources at head_dim 64-1224."""
    import torch

    device = torch.device("cuda")
    b, s, h, d = TRAIN["batch"], TRAIN["seq"], TRAIN["heads"], TRAIN["hidden"] // TRAIN["heads"]
    for name in FLASH_FP32 + FLASH_WIDE_FP32:
        rows.setdefault(name, {})["max_abs_err"] = 0.0
    cases = [(b, s, s, h, d, False), (b, s, s, h, d, True), (2, 500, 500, 4, 64, True), (2, 128, 384, 4, 64, True),
             (2, 384, 129, 4, 128, True), (2, 65, 200, 4, 24, False), (2, 300, 129, 2, 256, True),
             (2, 129, 300, 2, 160, False), (2, 129, 300, 2, 264, True), (2, 300, 129, 2, 320, True),
             (2, 129, 300, 2, 512, False), (1, 200, 200, 2, 1032, True)]
    # #1's wide body at its edges, causal and not
    cases += [(cb, sq, sk, 2, cd, c) for cb, sq, sk, cd in
              ((2, 200, 77, 136), (2, 77, 200, 248), (2, 300, 1, 256), (2, 32, 40, 264), (2, 33, 40, 264),
               (1, 70, 90, 1216), (1, 70, 90, 1224), (1, 77, 200, 1032)) for c in (False, True)]
    # #2 and #3's fp32 wide body at its edges: a ragged last TMA box (136),
    # one visible key both ways, the first streamed fixed tile (520)
    cases += [(2, 129, 300, 2, 136, True), (2, 300, 1, 2, 320, True), (2, 1, 300, 2, 512, True),
              (2, 300, 129, 2, 520, False)]
    # the reference's test shapes (tests/test_flash_kernel.py), causal and not
    cases += [(cb, sq, sk, 2, 32, c) for cb, sq, sk in ((2, 256, 256), (2, 128, 128), (1, 128, 384)) for c in (False, True)]
    # #2 and #3 up to head_dim 128 at each bucket's edges (8 and 32: one
    # 32-column box; 40 and 64: two; 72 and 128: four), lengths no multiple
    # of a tile both ways, causal and not
    bucket_cases = [(2, sq, sk, 2, cd, c) for cd in (8, 32, 40, 64, 72, 128) for sq, sk in ((65, 300), (300, 65))
                    for c in (False, True)]
    worst = {"flash_dq": 0.0, "flash_dkv": 0.0}
    for cb, sq, sk, ch, cd, causal in cases + bucket_cases:
        x = flash_inputs(device, cb, sq, sk, ch, cd, causal)
        for name, err in check_flash_case(x, f"{(cb, sq, sk, ch, cd)} causal={causal}").items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            if name in worst:
                worst[name] = max(worst[name], err)
    print(f"[kernels] #2 and #3 up to head_dim 128: worst |kernel - plain| dQ {worst['flash_dq']:.3e}, "
          f"dK/dV {worst['flash_dkv']:.3e} (#3 on the 3xTF32 mma.sync body at head_dim 24-128: 4.4e-5)")
    flash_resources()
    return rows


# -- 5b. the bf16 bodies of #1-#3 (mixed precision) ------------------------------------

# The bf16 kernels and their plain versions are both held against the
# float64 function of the same bf16 inputs: the kernel's max error may be
# at most twice the plain version's plus one bf16 ulp of the exact output's
# largest entry (taken of at least BF16_ULP_FLOOR: an output that is 0 in
# exact arithmetic, dQ and dK where one key is visible, holds f32 noise).
BF16_ULP_FLOOR = 2.0**-13


def bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(x, BF16_ULP_FLOOR))) - 7)


def check_bf16_case(x, tag, fwd_only=False):
    """The bf16 #1-#3 (#1 alone with fwd_only) on x against their plain
    versions by the float64 gate; returns {kernel: (max |kernel - exact|,
    max |plain - exact|)}."""
    import torch

    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    exact64 = {n: x[n].double() for n in ("q", "k", "v", "do")}
    args64 = (exact64["q"], exact64["k"], exact64["v"])
    exact = {
        "flash_fwd": fk.flash_fwd_ref(*args64, x["causal"])[:1],
        "flash_dq": (fk.flash_dq_ref(*args64, exact64["do"], x["lse"], x["delta"], x["causal"]),),
        "flash_dkv": fk.flash_dkv_ref(*args64, exact64["do"], x["lse"], x["delta"], x["causal"]),
    }
    errs = {}
    for name, (kernel, plain) in flash_calls(x).items():
        if fwd_only and flash_base(name) != "flash_fwd":
            continue
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        lse = ""
        if flash_base(name) == "flash_fwd":
            lse_err = float((got[1] - want[1]).abs().max())
            require(lse_err <= ATOL_FLASH_FWD, f"{name} {tag}: LSE error {lse_err}")
            lse = f", LSE max |kernel - plain| = {lse_err:.3e}"
        k_err = p_err = 0.0
        for a, p, e in zip(got, want, exact[flash_base(name)]):
            ke, pe = float((a.double() - e).abs().max()), float((p.double() - e).abs().max())
            limit = 2 * pe + bf16_ulp(float(e.abs().max()))
            require(a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()) and ke <= limit,
                    f"{name} {tag}: kernel error {ke} against float64, limit {limit} (plain {pe})")
            k_err, p_err = max(k_err, ke), max(p_err, pe)
        print(f"[kernels] {name} {tag}: max |kernel - float64| = {k_err:.3e}, max |plain - float64| = {p_err:.3e}"
              + lse)
        errs[name] = (k_err, p_err)
    return errs


def time_flash_bf16_kernels(shapes):
    """The bf16 #1-#3 at `shapes` ((seq, heads, head_dim, causal) at the
    flagship's batch): times (event timer and profiler), bounds, plain
    times and PyTorch's bf16 SDPA (forward beside #1, backward beside the
    #2 + #3 pair) with the backend it ran. Past head_dim 256 the calls are
    the bf16 wide kernels, timed after wide cases, where the profiler may
    read part of a call (None then: scripts/flash_bf16_device_time.py
    --shape reads them in a fresh process), and each is held against
    float64 at the timed shape after its timings (check_bf16_case).
    Returns the kernels-line rows of each kernel's first non-causal
    shape."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    device = torch.device("cuda")
    b = TRAIN["batch"]
    rows = {}
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    flush = lambda: flush_buf.zero_()
    for ts, th, td, causal in shapes:
        x = flash_inputs(device, b, ts, ts, th, td, causal, dtype=torch.bfloat16)
        tag = f"bf16 {'causal' if causal else 'non-causal'} [{b}, {ts}, {th}, {td}]"
        if td > 256:  # the instantiation of #1's wide body this grid runs
            tag += f" (#1 on flash_fwd_wide_bf16_wgmma_kernel<{fk.wide_boxes(b, th, ts, td)}>)"
        dev, first = {}, {}
        for name, (kernel, plain) in flash_calls(x).items():
            ms, plain_ms = time_ms(kernel, flush), time_ms(plain, flush, iters=10, warmup=2)
            dev[flash_base(name)] = device_ms(kernel, flush)
            bound, by = flash_bound_ms(x, name)
            print(f"[kernels] {name} {tag}: {ms:.4f} ms, device {dev[flash_base(name)]} ms (bound {bound:.4f} ms, "
                  f"{by}), plain {plain_ms:.4f} ms")
            first[name] = not causal and name not in rows
            if first[name]:
                rows[name] = dict(ms=ms, device_ms=dev[flash_base(name)], plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        qt, kt, vt, dot = (x[n].transpose(1, 2).contiguous().requires_grad_(n != "do") for n in ("q", "k", "v", "do"))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        out = sdpa()
        sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        lib_fwd, lib_bwd = time_ms(sdpa, flush), time_ms(sdpa_bwd, flush)
        (lib_fwd_dev, fwd_backend), (lib_bwd_dev, bwd_backend) = (
            device_ms(sdpa, flush, top=True), device_ms(sdpa_bwd, flush, top=True)
        )
        pair = None if None in (dev["flash_dq"], dev["flash_dkv"]) else dev["flash_dq"] + dev["flash_dkv"]
        print(f"[kernels] {tag}: library bf16 SDPA forward {lib_fwd:.4f} ms, device {lib_fwd_dev} ms "
              f"({fwd_backend}), backward {lib_bwd:.4f} ms, device {lib_bwd_dev} ms "
              f"({bwd_backend}); bf16 #1 device {dev['flash_fwd']} ms, #2 + #3 device {pair} ms")
        for name, take in first.items():
            if take:
                rows[name]["library_ms"] = lib_fwd if flash_base(name) == "flash_fwd" else lib_bwd
        del out
        if td > 256:  # the float64 gate at the timed shape itself, after its timings
            check_bf16_case(x, tag)
    return rows


def check_flash_bf16_kernels(rows):
    """The bf16 #1-#3 against their plain versions by the float64 gate at
    the flagship shape (causal and not), ragged (sq 500, sq != sk), head_dim
    24-256 (the wgmma bodies of #1-#3 at their tile edges too, one visible
    key included), past 256 (264-2056) and the reference's test shapes,
    each kernel's worst error into `rows` (#1's wide body also alone at its
    edges); resources at head_dim 64, 128 and 256 (#1's wide body at 264,
    320, 512 and 1032, with no spilled register), no ptxas advisory that
    it serialized the wgmma's of any body, and the HMMA and HGMMA counts of
    the bf16 library's SASS (HGMMA required)."""
    import torch

    from flexflow_tpu_torch.ops.cuda import _build
    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    device = torch.device("cuda")
    b, s, h, d = TRAIN["batch"], TRAIN["seq"], TRAIN["heads"], TRAIN["hidden"] // TRAIN["heads"]
    for name in FLASH_BF16 + FLASH_WIDE_BF16:
        rows.setdefault(name, {})["max_abs_err"] = 0.0
    cases = [(b, s, s, h, d, False), (b, s, s, h, d, True), (2, 500, 500, 4, 64, True), (2, 500, 380, 4, 64, False),
             (2, 128, 384, 4, 64, True), (2, 200, 77, 3, 24, False), (2, 384, 129, 4, 128, True),
             (1, 96, 160, 2, 160, False), (2, 129, 300, 2, 256, True)]
    # #1's wgmma body: ragged against its 128-row query and key tiles,
    # head_dims whose last 64-column TMA box is part zero-filled
    cases += [(2, 127, 129, 3, 40, True), (2, 255, 257, 3, 136, False), (2, 1, 300, 3, 200, True),
              (2, 300, 1, 3, 256, False)]
    # #2 and #3's wgmma bodies: ragged against their 128-row fixed tiles
    # and 64- or 128-row loop tiles, sq != sk both ways; one visible key
    # (dQ and dK 0 in exact arithmetic) at each head_dim bucket
    cases += [(2, 129, 127, 3, 24, True), (2, 257, 255, 2, 200, True), (2, 130, 300, 2, 128, False),
              (2, 300, 130, 2, 64, True)]
    cases += [(2, 300, 1, 3, dd, c) for dd in (64, 128, 192) for c in (False, True)]
    # past head_dim 256: the wide kernels for bf16 (#1 in output chunks of
    # 2 boxes at these grids of one wave; #2 and #3 in streamed pieces;
    # ragged, sq != sk both ways)
    cases += [(2, 129, 300, 2, 264, True), (2, 129, 300, 2, 264, False), (2, 300, 129, 2, 320, True),
              (2, 300, 129, 2, 320, False), (1, 200, 77, 2, 512, False), (1, 200, 77, 2, 512, True)]
    # bf16 #1's Q tile streamed beside K past its resident width (640)
    cases += [(1, 130, 70, 1, dd, c) for dd in (1032, 2056) for c in (False, True)]
    cases += [(cb, sq, sk, 2, 32, c) for cb, sq, sk in ((2, 256, 256), (2, 128, 128), (1, 128, 384)) for c in (False, True)]
    # bf16 #1's wide wgmma body alone at its edges: output chunks of 2
    # boxes at these grids of one wave (the last chunk's last box past d
    # at 264, 320, 520 and 648), 11 chunks of 3 at 2056, Q resident at 640
    # and streamed from 648 (1032, 2056); at 320 and 512 one visible key
    # (sq 300, sk 1: LSE is the score chains' sum alone) and query lengths
    # around a warpgroup's 64 rows and the 128-row tile
    fwd_cases = [(2, 129, 300, 2, dd, c) for dd in (264, 320, 328, 384, 512, 520, 640, 648, 1032, 2056)
                 for c in (False, True)]
    fwd_cases += [(1, sq, sk, 2, dd, c) for dd in (320, 512) for sq, sk in ((300, 1), (64, 64), (65, 70), (128, 128),
                                                                           (129, 129)) for c in (False, True)]
    # grids of many waves, where wide_boxes takes chunks of 3 boxes (264,
    # 320, 328: chunk 1's last box past d or part zero-filled) or of 4
    # (512; 392, chunk 1's last box past d; 1032, Q streamed), ragged and
    # sq != sk at 328 and 392; (b, sq, sk, h, d) -> the boxes a chunk takes
    many_waves = {(8, 512, 512, 4, 264): 3, (8, 512, 512, 4, 320): 3, (8, 500, 380, 4, 328): 3,
                  (8, 512, 512, 4, 512): 4, (8, 500, 380, 4, 392): 4, (4, 512, 512, 8, 1032): 4}
    for (cb, sq, sk, ch, cd), boxes in many_waves.items():
        got = fk.wide_boxes(cb, ch, sq, cd)
        require(got == boxes, f"flash_fwd_wide_bf16 at {(cb, sq, sk, ch, cd)} takes {got} boxes a chunk, not {boxes}")
    fwd_cases += [(*shape, c) for shape in many_waves for c in (False, True)]
    for only, group in ((False, cases), (True, fwd_cases)):
        for cb, sq, sk, ch, cd, causal in group:
            x = flash_inputs(device, cb, sq, sk, ch, cd, causal, dtype=torch.bfloat16)
            for name, (k_err, _) in check_bf16_case(x, f"{(cb, sq, sk, ch, cd)} causal={causal}", only).items():
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], k_err)
    log = _build.build_logs.get(fk.BF16_SOURCE, "").splitlines()

    def ptxas(sym):
        info = []
        for i, line in enumerate(log):
            if "Compiling entry function" in line and sym in line:
                info = [t.strip() for t in log[i + 1 : i + 4] if "registers" in t or "spill" in t]
        return "; ".join(info) or "not in the build log"

    for dd in (64, 128, 256):
        for name in FLASH_BF16:
            # the wgmma bodies are instantiated at 64, 128, 192 and 256
            fn = f"{name}_wgmma_kernel<{dd}>"
            sym = fn.replace("<", "ILi").replace(">", "E")
            print(f"[resources] {name} at head_dim {dd} ({fn}): " + json.dumps(fk.occupancy(name, dd))
                  + f"; ptxas: {ptxas(sym)}")
    serialized = [line.strip() for line in log if "wgmma.mma_async instructions are serialized" in line]
    require(not serialized, f"ptxas serialized the bf16 bodies' wgmma's: {serialized}")
    for kb in (2, 3, 4):  # the wide body's instantiations: 64-column boxes of O a work tile
        fn = f"flash_fwd_wide_bf16_wgmma_kernel<{kb}>"
        print(f"[resources] {fn}: ptxas: {ptxas(fn.replace('<', 'ILi').replace('>', 'E'))}")
        for dd in (264, 320, 512, 1032):  # shared memory grows with Q up to 640
            occ = fk.occupancy("flash_fwd_wide_bf16", dd, kb)
            print(f"[resources] flash_fwd_wide_bf16 at head_dim {dd} ({fn}): " + json.dumps(occ))
            require(occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1,
                    f"flash_fwd_wide_bf16 at head_dim {dd} ({fn}) spills or does not fit: {occ}")
    ops = sass_opcodes(fk.BF16_SOURCE)
    require(ops is not None, f"{fk.BF16_SOURCE}: cuobjdump not found, SASS not read")
    print(f"[resources] {fk.BF16_SOURCE}: {ops.get('HMMA', 0)} HMMA and {ops.get('HGMMA', 0)} HGMMA (wgmma) "
          "instructions in its SASS; top opcodes " + json.dumps(ops.most_common(14)))
    require(ops.get("HGMMA", 0) > 0, f"{fk.BF16_SOURCE}: no HGMMA instruction in its SASS")
    return rows


# -- 6. train the flagship Transformer -------------------------------------------


def build_transformer(device, layers, hidden, heads, batch, seq, use_flash="auto", seed=SEED, mixed=False, **_):
    """examples/transformer.py's build_transformer, reproduced on the port:
    12 x [MHA -> dense+ReLU -> dense] -> dense(1), SGD lr 0.01, MSE; with
    `mixed`, compiled with allow_mixed_precision as bench.py runs it."""
    from flexflow_tpu_torch import ActiMode, FFConfig, FFModel, LossType, SGDOptimizer

    model = FFModel(FFConfig(batch_size=batch, learning_rate=0.01, seed=seed, allow_mixed_precision=mixed))
    t = model.create_tensor([batch, seq, hidden], name="x")
    for _ in range(layers):
        t = model.multihead_attention(t, t, t, hidden, heads)
        t = model.dense(t, hidden, activation=ActiMode.RELU, use_bias=False)
        t = model.dense(t, hidden, use_bias=False)
    t = model.dense(t, 1, use_bias=False)
    for node in model.graph.nodes.values():
        if node.op_type.name == "MULTIHEAD_ATTENTION":
            node.params["use_flash"] = use_flash
    model.compile(
        optimizer=SGDOptimizer(lr=0.01),
        loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
        metrics=[],
        device=device,
    )
    return model


def synthetic_batch(batch, seq, hidden, seed=SEED):
    """examples/transformer.py's synthetic_batch: seeded randn x and label."""
    rng = np.random.RandomState(seed)
    return {
        "x": rng.randn(batch, seq, hidden).astype(np.float32),
        "label": rng.randn(batch, seq, 1).astype(np.float32),
    }


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def profile_train_step(model, batch, label=""):
    """Device time by kernel over one train step (torch.profiler), each
    flash kernel's device ms and launches in it, and the host ops that
    take most CPU time; None when the profiler sees no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = model.executor.train_step()
    tensors = model.executor.shard_batch(batch)
    sync(model.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.params, model.opt_state, loss, _ = step(model.params, model.opt_state, tensors, 0)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    device_us = sum(e.self_device_time_total for e in events)
    if not events or device_us <= 0:
        print("[profile] no device time recorded: device busy share not measured")
        return None
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    flash = {}
    for name in FLASH_FP32 + FLASH_BF16:
        mine = [e for e in events if any(k in e.key for k in KERNEL_SYMBOLS[name])]
        flash[name] = (sum(e.self_device_time_total for e in mine) / 1e3, sum(e.count for e in mine))
    host = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0),
        key=lambda e: -e.self_cpu_time_total,
    )[:8]
    out = dict(
        wall_ms=1e3 * wall_s,
        device_ms=device_us / 1e3,
        device_busy_share=device_us / 1e6 / wall_s,
        flash_ms_and_launches=flash,
        top=[(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in top],
        # host ops by their own CPU time (profiler clock, inflated by the
        # profiler's own per-op cost)
        top_host=[(e.key[:60], e.self_cpu_time_total / 1e3, e.count) for e in host],
    )
    print(f"[profile] {label}train step: " + json.dumps(out))
    return out


def train_flagship(device, mixed=False, **geo):
    """fit() over `steps` batches; each flash kernel of the model's dtype
    and head_dim (the fp32 bodies, or the bf16 ones under mixed precision;
    the wide ones past head_dim 128 in fp32 and 256 in bf16) must run once
    per layer per step, no other body ever, and the losses stay finite."""
    import torch

    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    geo = dict(TRAIN, **geo)
    t0 = time.perf_counter()
    model = build_transformer(device, mixed=mixed, **geo)
    nparams = sum(w.numel() for ws in model.params.values() for w in ws)
    data = synthetic_batch(geo["batch"] * geo["steps"], geo["seq"], geo["hidden"])
    label = "mixed precision (bf16)" if mixed else ""
    shape = "flagship Transformer" if geo == TRAIN else \
        f"Transformer ({geo['layers']} layers, {geo['heads']} heads of {geo['hidden'] // geo['heads']})"
    print(f"[train] {shape}, {label or 'fp32'}: {nparams / 1e6:.1f} M params, built in "
          f"{time.perf_counter() - t0:.2f} s")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        sync(device)
        torch.cuda.reset_peak_memory_stats()
    fk.reset_launches()
    hist = model.fit(data["x"], data["label"], epochs=1, batch_size=geo["batch"])
    sync(device)
    launches = dict(fk.LAUNCHES)
    steps = hist[0]["iterations"]
    require(steps == geo["steps"], f"fit ran {steps} steps, not {geo['steps']}")
    mean_loss = hist[0]["loss_sum"] / max(1, hist[0]["train_all"])
    require(np.isfinite(mean_loss), f"non-finite training loss {mean_loss}")
    if cuda:
        # the bodies of the model's dtype and head_dim run, no other
        wide = geo["hidden"] // geo["heads"] > (256 if mixed else 128)
        if mixed:
            ran = FLASH_WIDE_BF16 if wide else FLASH_BF16
        else:
            ran = FLASH_WIDE_FP32 if wide else FLASH_FP32
        for name in ran:
            n = launches[name]
            require(n == geo["layers"] * steps, f"{name} launches {n} != {geo['layers']} layers x {steps} steps")
        for name in set(launches) - set(ran):
            require(launches[name] == 0, f"{name} launched {launches[name]} times in the {label or 'fp32'} run")
    thpt = hist[0]["throughput"]
    summary = dict(
        steps=steps,
        mean_loss=mean_loss,
        samples_per_s=thpt,
        mean_step_ms=1e3 * geo["batch"] / thpt if thpt else None,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        launches=launches,
    )
    print(f"[train] {label + ' ' if label else ''}" + json.dumps(summary))
    return model, data, summary, launches


# -- 7. training checks on the card ---------------------------------------------------


def one_step(model, batch):
    """One train step; (loss, peak device memory in GB or None)."""
    import torch

    cuda = model.device.type == "cuda"
    sync(model.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    step = model.executor.train_step()
    model.params, model.opt_state, loss, _ = step(model.params, model.opt_state, model.executor.shard_batch(batch), 0)
    sync(model.device)
    return float(loss), (torch.cuda.max_memory_allocated() / 1e9 if cuda else None)


def _max_abs(ts):
    return max(float(t.detach().abs().max()) for t in ts)


def check_flash_vs_dense(model, data, **geo):
    """From the same weights on one batch, the flash kernels (#1 forward,
    #2 and #3 backward) and the dense core give the same gradient of every
    weight, measured against that gradient's own size; then one step of
    each gives the same loss and weights, and the step's own size is
    printed beside the weights' limit."""
    from flexflow_tpu_torch.runtime.interop import params_from_host

    geo = dict(TRAIN, **geo)
    dense = build_transformer(model.device, use_flash=False, **geo)
    params_from_host(dense, model.executor.export_host_params(model.params))
    batch = {k: v[: geo["batch"]] for k, v in data.items()}
    flash_g = model.executor.grad_fn()(model.params, model.executor.shard_batch(batch))
    dense_g = dense.executor.grad_fn()(dense.params, dense.executor.shard_batch(batch))
    grad_size = _max_abs(t for gs in dense_g.values() for t in gs)
    floor = GRAD_FLOOR * grad_size
    grad_rel, worst = 0.0, None
    for g, gs in dense_g.items():
        for i, (a, b) in enumerate(zip(flash_g[g], gs)):
            rel = float((a - b).abs().max()) / max(float(b.abs().max()), floor)
            if rel >= grad_rel:
                grad_rel, worst = rel, (g, i)
    del flash_g, dense_g
    before = [w.detach().clone() for ws in dense.params.values() for w in ws]
    flash_loss, flash_gb = one_step(model, batch)
    dense_loss, dense_gb = one_step(dense, batch)
    after = [w.detach() for ws in dense.params.values() for w in ws]
    step_max = _max_abs(a - b for a, b in zip(after, before))
    step_mean = float(sum((a - b).abs().sum() for a, b in zip(after, before)) / sum(b.numel() for b in before))
    del before
    rel = abs(flash_loss - dense_loss) / max(abs(dense_loss), 1e-30)
    err = max(
        float((a.detach() - b.detach()).abs().max())
        for g, ws in model.params.items()
        for a, b in zip(ws, dense.params[g])
    )
    print(f"[checks] flash vs dense core, same weights and batch: gradients max |diff| / max |grad| "
          f"{grad_rel:.2e} (worst: guid {worst[0]} weight {worst[1]}; largest |grad| {grad_size:.3e}, "
          f"limit {RTOL_GRAD_FLASH_DENSE:.0e}); one step: loss {flash_loss:.6f} vs {dense_loss:.6f} "
          f"(rel {rel:.2e}), weights max |diff| {err:.2e} (limit {ATOL_STEP_WEIGHTS:.0e}) against a step of "
          f"max |dw| {step_max:.3e}, mean |dw| {step_mean:.3e}; peak memory {flash_gb} vs {dense_gb} GB")
    require(grad_rel <= RTOL_GRAD_FLASH_DENSE, f"flash and dense gradients differ by {grad_rel} relative at {worst}")
    require(rel <= RTOL_STEP_LOSS, f"flash and dense losses differ by {rel} relative")
    require(err <= ATOL_STEP_WEIGHTS, f"flash and dense weights differ by {err}")
    return dict(grad_rel=grad_rel, loss_rel=rel, weights_err=err, step_max=step_max, step_mean=step_mean,
                peak_gb_flash=flash_gb, peak_gb_dense=dense_gb)


def check_loss_falls(model, data, steps=10):
    batch = {k: v[: model.config.batch_size] for k, v in data.items()}
    losses = [one_step(model, batch)[0] for _ in range(steps)]
    print(f"[checks] {steps} steps on one batch: loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0], f"loss did not fall: {losses}")
    return losses


def compare_loss_curves(device, steps=TRAIN["steps"], **geo):
    """The flagship in fp32 and under mixed precision from the same initial
    weights, `steps` SGD steps each on the same batch: both loss curves,
    held at the last step by the reference's criterion
    (tests/test_precision.py): |bf16 - fp32| < 0.25 |fp32| + 0.05."""
    from flexflow_tpu_torch.runtime.interop import params_from_host

    geo = dict(TRAIN, **geo)
    batch = synthetic_batch(geo["batch"], geo["seq"], geo["hidden"], seed=SEED + 1)
    curves = {}
    fp32 = build_transformer(device, **geo)
    host = fp32.executor.export_host_params(fp32.params)
    curves["fp32"] = [one_step(fp32, batch)[0] for _ in range(steps)]
    del fp32
    bf16 = build_transformer(device, mixed=True, **geo)
    params_from_host(bf16, host)
    del host
    curves["bf16"] = [one_step(bf16, batch)[0] for _ in range(steps)]
    del bf16
    last_fp32, last_bf16 = curves["fp32"][-1], curves["bf16"][-1]
    limit = 0.25 * abs(last_fp32) + 0.05
    print(f"[train] {steps}-step loss curves from the same weights and batch: fp32 "
          f"{json.dumps([round(x, 6) for x in curves['fp32']])}; bf16 {json.dumps([round(x, 6) for x in curves['bf16']])}; "
          f"last step |bf16 - fp32| = {abs(last_bf16 - last_fp32):.6f} (limit {limit:.6f})")
    require(all(np.isfinite(curves["bf16"])), f"non-finite bf16 losses {curves['bf16']}")
    require(abs(last_bf16 - last_fp32) < limit, f"bf16 loss {last_bf16} strays from fp32 {last_fp32}")
    return curves


def train_causal_lm(device, layers=LM_TRAIN["layers"], steps=LM_TRAIN["steps"], mixed=False):
    """The decoder LM at full width trains through fit() with sparse CE;
    each flash kernel of its dtype runs once per layer per step (causal),
    the other dtype's never."""
    import torch

    from flexflow_tpu_torch import DataType, FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu_torch.models import build_decoder_lm
    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    b, s, vocab = FLAGSHIP["max_seqs"], FLAGSHIP["max_len"], FLAGSHIP["vocab"]
    model = FFModel(FFConfig(batch_size=b, seed=SEED, allow_mixed_precision=mixed))
    tok = model.create_tensor([b, s], dtype=DataType.INT32, name="tokens")
    build_decoder_lm(model, tok, vocab_size=vocab, hidden=FLAGSHIP["hidden"], num_heads=FLAGSHIP["heads"],
                     num_layers=layers, ff_dim=4 * FLAGSHIP["hidden"])
    model.compile(SGDOptimizer(lr=0.01), LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [], device=device)
    rng = np.random.RandomState(SEED)
    tokens = rng.randint(0, vocab, (b * steps, s + 1)).astype(np.int32)
    sync(device)
    fk.reset_launches()
    hist = model.fit(tokens[:, :-1], tokens[:, 1:], epochs=1, batch_size=b)
    sync(device)
    launches = dict(fk.LAUNCHES)
    mean_loss = hist[0]["loss_sum"] / max(1, hist[0]["train_all"])
    require(hist[0]["iterations"] == steps and np.isfinite(mean_loss), f"causal LM: {hist}")
    if torch.device(device).type == "cuda":
        ran = FLASH_BF16 if mixed else FLASH_FP32
        for name, n in launches.items():
            want = layers * steps if name in ran else 0
            require(n == want, f"causal LM: {name} launches {n} != {want}")
    print(f"[checks] causal decoder LM{' under mixed precision' if mixed else ''}, {layers} layers: {steps} steps, "
          f"mean loss {mean_loss:.4f} "
          f"(ln {vocab} = {np.log(vocab):.4f}), {hist[0]['throughput']:.2f} samples/s, launches {launches}")
    return launches


# -- main ------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import flexflow_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(flexflow_tpu_torch.__file__)))
    if pkg_root != ROOT:
        print(f"chip_smoke: flexflow_tpu_torch comes from {pkg_root}, not {ROOT}", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    build_kernels()
    smi_idle = smi_sample()
    warm_card()
    smi_before = smi_sample()
    rows = check_kernels()
    rows.update(check_spec_kernels())
    rows.update(check_bf16_q_kernels())
    check_split_body_edges()
    print(f"[kernels] nvidia-smi clocks.sm, clocks.max.sm, power.draw, temperature: "
          f"at the start [{smi_idle}], after a 2 s warm-up, before the decode kernel "
          f"timings [{smi_before}], after them [{smi_sample()}]")
    model, flagship, main_launches, burst = serve_flagship("cuda")
    profile_decode(model, kernel="paged_flash_verify")
    multistep_burst(model, burst)
    graph_a = multistep_leg("a: fp32 paged", model, FLAGSHIP["layers"], "paged_flash_verify")["graph"]
    multistep_leg("b: int8 paged", model, FLAGSHIP["layers"], "paged_flash_verify_quant", kv_dtype="int8")
    del model
    model2, layout_launches = check_layouts("cuda")
    check_decode_logits(model2)
    multistep_leg("c: slot, 2 layers", model2, 2, "flash_verify", kv_layout="slot")
    del model2
    spec_launches, fp32_legs = serve_spec("cuda")
    # the spec legs' recording wrappers close reference cycles around
    # their schedulers, engines and pools: free them before the training
    # phases measure peak memory
    gc.collect()
    # 4d: the flagship under mixed precision, each leg beside its fp32 run
    fp32_legs["burst"] = dict(tokens_per_s=flagship["tokens_per_s"], mean_step_ms=flagship["mean_decode_step_ms"],
                              ttft_p50_ms=flagship["ttft_p50_ms"], ttft_p95_ms=flagship["ttft_p95_ms"])
    fp32_legs["graph"] = dict(tokens_per_s=graph_a["tokens_per_s"], mean_step_ms=graph_a["step_ms"])
    mixed_serving_launches = serve_mixed("cuda", fp32_legs)
    gc.collect()
    # 4e: sampling, chunked prefill, prefix cache and optimistic admission
    serve_features("cuda")
    gc.collect()
    # 4f: the async double-buffered loop beside the sync one
    serve_async_legs("cuda")
    gc.collect()
    # 4g: multi-tenant serving (adapters, weighted-fair classes) and the
    # small-model draft
    serve_tenancy("cuda", burst)
    gc.collect()
    # after the serving phases, so the decode profile stays the run's
    # first profiler session, as it was before the training phases
    # existed
    # 5 and 5b: every flagship-shape timing first (FLASH_TIMED says why),
    # then the wide shapes' timings and the correctness cases
    smi_before = smi_sample()
    flash_rows = time_flash_kernels(FLASH_TIMED)
    flash_rows.update(time_flash_bf16_kernels(FLASH_TIMED + FLASH_TIMED_BF16))
    # the fp32 wide kernels' rows: their first non-causal shape, [8, 512, 4, 320]
    wide_rows = time_flash_kernels(FLASH_TIMED_WIDE)
    flash_rows.update((k, v) for k, v in wide_rows.items() if k in FLASH_WIDE_FP32)
    # past 256: the bf16 wide kernels, #1's wide body causal too
    flash_rows.update(time_flash_bf16_kernels(FLASH_TIMED_WIDE_BF16))
    print(f"[kernels] nvidia-smi clocks.sm, clocks.max.sm, power.draw, temperature: "
          f"before the flash kernel timings [{smi_before}], after them [{smi_sample()}]")
    check_flash_kernels(flash_rows)
    check_flash_bf16_kernels(flash_rows)
    rows.update((k, v) for k, v in flash_rows.items() if k in KERNELS)
    # what the kernel phases left to the garbage collector is freed before
    # the training phases read peak memory
    gc.collect()
    model3, data, fp32_summary, train_launches = train_flagship("cuda")
    fp32_profile = profile_train_step(model3, {k: v[: TRAIN["batch"]] for k, v in data.items()})
    check_flash_vs_dense(model3, data)
    check_loss_falls(model3, data)
    del model3
    gc.collect()
    # 6b: the same flagship under mixed precision (bench.py's mode)
    model4, data, mixed_summary, mixed_launches = train_flagship("cuda", mixed=True)
    mixed_profile = profile_train_step(model4, {k: v[: TRAIN["batch"]] for k, v in data.items()}, "mixed precision (bf16) ")
    del model4
    gc.collect()
    # #1-#3 past head_dim 256 on a training path: 2 layers of 2 heads of
    # 320, in fp32 (the wide kernels) and under mixed precision (the bf16
    # wide kernels), 2 launches each per step
    wide_geo = dict(layers=2, hidden=640, heads=2, batch=2, seq=256, steps=3)
    model5, _, _, wide_fp32_launches = train_flagship("cuda", **wide_geo)
    del model5
    gc.collect()
    model5, _, _, wide_launches = train_flagship("cuda", mixed=True, **wide_geo)
    del model5
    gc.collect()
    keys = ("samples_per_s", "mean_step_ms", "peak_memory_gb")
    print("[train] fp32 vs mixed precision, same call: "
          + json.dumps({k: [fp32_summary[k], mixed_summary[k]] for k in keys})
          + "; device ms and busy share of a profiled step: "
          + json.dumps({label: None if prof is None else [prof["device_ms"], prof["device_busy_share"]]
                        for label, prof in (("fp32", fp32_profile), ("bf16", mixed_profile))}))
    compare_loss_curves("cuda")
    train_causal_lm("cuda")
    train_causal_lm("cuda", mixed=True)
    launches = {
        "paged_flash_verify": main_launches["paged_flash_verify"],
        "flash_verify": layout_launches["slot"]["flash_verify"],
        **spec_launches,
        **mixed_serving_launches,
        **{name: wide_launches[name] for name in FLASH_WIDE_BF16},
        **{name: wide_fp32_launches[name] for name in FLASH_WIDE_FP32},
        **{name: train_launches[name] for name in FLASH_FP32},
        **{name: mixed_launches[name] for name in FLASH_BF16},
    }
    for name, n in launches.items():
        require(n > 0, f"{name} was never launched on its path")
    line = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        line["kernels"].append(
            {
                "name": name,
                "route": "cuda",
                "source": "flexflow_tpu_torch/csrc/" + source,
                "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": r["max_abs_err"],
                "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
            }
        )
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
