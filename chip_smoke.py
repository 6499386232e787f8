#!/usr/bin/env python3
"""On-card smoke test of flexflow_tpu_torch, the PyTorch + CUDA port.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports torch, numpy and the port only, and fails (non-zero exit, no
result line) on any failed phase:

  1. build   — compiles every kernel source of csrc/ with nvcc for
               sm_90a, all at once, and prints each build's time and
               ptxas report;
  2. kernels — after a 2 s warm-up that brings the card to its working
               clock, each decode kernel against its plain PyTorch
               version at the serving path's shapes (8 sequences x 16
               heads x 64, max_len 512, 16-row pages, 256 pages): #4 and
               #5 at w = 1 and 5 (atol 1e-4), #6 on int8 pools with a
               scale-0 page at w = 1 and 5, #7-#9 under a seeded random
               draft tree at w = 13 and #7, #8 (the split-KV tree body of
               tree_kernel.cu) also at w = 64 (atol 1e-5), with times,
               bounds, a library yardstick where PyTorch has one and the
               card's clocks and power, and for #7 and #8 (with their
               plain versions and the library call) the profiler's
               device time and the host time of one call;
  3. serve   — the flagship decoder LM (12 layers, hidden 1024, 16
               heads, ff 4096, vocab 32000, seeded random weights) serves
               32 requests on 8 slots x 512 tokens under the default
               paged ServeConfig; every request must finish and the paged
               kernel must run once per layer per decode step;
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
               window of (b)'s, (c)'s and (d)'s steps with the leg's
               kernel's device time per launch beside the step's GEMMs;
  5. flash kernels — #1-#3 against their plain versions at the flagship
               training shape (q, k, v [8, 512, 16, 64]), causal and
               not, and ragged (sq 500, sq != sk, head_dim 24 and 128):
               O and LSE within atol 1e-4, dQ, dK, dV within atol 1e-4
               and rtol 1e-3, with times (the event timer's and the
               profiler's device time per call), bounds, the library
               call (SDPA forward, SDPA backward for the #2 + #3 pair,
               with the device kernel each runs), the port's dense core,
               each kernel's registers, spills, shared memory and blocks
               per SM, the count of tensor-core (HMMA) instructions in
               each flash library's SASS, and the card's clocks and
               power;
  6. train   — the flagship Transformer (examples/transformer.py: 12 x
               [MHA(1024, 16 heads) -> dense+ReLU -> dense] -> dense(1),
               batch 8, seq 512, fp32, SGD lr 0.01, MSE) trains through
               fit() for 10 iterations of seeded randn data; each flash
               kernel must run 12 times per step and the loss stay
               finite; samples/s, step ms, peak memory and a profiled
               step's device busy share and top device ops;
  7. training checks — from the same weights and batch, the flash kernels
               and the dense core give each weight's gradient within 1e-3
               of its largest entry, and one step of each agrees (loss
               1e-5 relative, weights 1e-5 absolute, printed beside the
               step's own size; peak memory of both); the
               loss falls over 10 steps on one batch; and the causal
               decoder LM at full width (2 layers, tokens [8, 512],
               sparse CE, SGD lr 0.01) trains through fit() for 4
               iterations with each flash kernel run 2 times per step;

then prints the kernels' JSON line (launches: the serving path's for
#4 and #5, legs (c), (e), (b) and (d) for #6-#9, the flagship training
run's for #1-#3), the card's name and
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
# H100 SXM, TF32 tensor cores, dense; fp32-accurate products take 3 passes
TF32_FLOPS_PER_S = 495e12
TF32_PASSES = 3

ATOL_GRAD, RTOL_GRAD = 1e-4, 1e-3  # flash backward kernels vs plain versions
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
# the flagship Transformer of examples/transformer.py and its training run
TRAIN = dict(layers=12, hidden=1024, heads=16, batch=8, seq=512, steps=10)
LM_TRAIN = dict(layers=2, steps=4)

# kernel wrapper -> (source, the TPU kernel it replaces)
KERNELS = {
    "flash_verify": ("decode_kernel.cu", "flexflow_tpu/ops/pallas/decode_kernel.py:235"),
    "paged_flash_verify": ("decode_kernel.cu", "flexflow_tpu/ops/pallas/decode_kernel.py:342"),
    "paged_flash_verify_quant": ("decode_kernel.cu", "flexflow_tpu/ops/pallas/decode_kernel.py:476"),
    "flash_verify_tree": ("tree_kernel.cu", "flexflow_tpu/ops/pallas/decode_kernel.py:626"),
    "paged_flash_verify_tree": ("tree_kernel.cu", "flexflow_tpu/ops/pallas/decode_kernel.py:732"),
    "paged_flash_verify_tree_quant": ("decode_kernel.cu", "flexflow_tpu/ops/pallas/decode_kernel.py:849"),
    "flash_fwd": ("flash_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:129"),
    "flash_dq": ("flash_bwd_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:230"),
    "flash_dkv": ("flash_bwd_kernel.cu", "flexflow_tpu/ops/pallas/flash_kernel.py:269"),
}

# kernel wrapper -> substrings of the device functions its launches run,
# as the profiler names them
KERNEL_SYMBOLS = {
    "paged_flash_verify_tree": ("tree_attention_kernel",),
    "paged_flash_verify_quant": ("decode_attention_kernel<true, true, false>",),
    "paged_flash_verify_tree_quant": ("decode_attention_kernel<true, true, true>",),
    "flash_fwd": ("flash_fwd_kernel",),
    "flash_dq": ("flash_dq_mma_kernel",),
    "flash_dkv": ("flash_dkv_mma_kernel",),
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
    builds = {dk.SOURCE: dk._lib, dk.TREE_SOURCE: dk._tree_lib, fk.SOURCE: fk._lib, fk.BWD_SOURCE: fk._bwd_lib}
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


def kernel_inputs(device, w, b=8, h=16, d=64, max_len=512, page=16, num_pages=256, seed=SEED):
    """Seeded operands at the serving shapes. Lengths include 0 and
    max_len - w; block tables hold each sequence's pages in random pool
    order, sentinels past its length, one row with a sentinel hole inside
    its visible range and one dead row whose pages are all sentinels."""
    import torch

    from flexflow_tpu_torch.ops.attention import tree_allowed_mask

    rng = np.random.default_rng(seed + w)
    lengths = rng.integers(0, max_len - w + 1, size=b).astype(np.int32)
    lengths[0], lengths[1] = 0, max_len - w
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
    nbytes = 4 * (2 * b * w * h * d + b) + (1 if quant else 4) * 2 * nrows * h * d
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


def device_ms(fn, flush, iters=20):
    """Device time of one call from the profiler: the kernels that `iters`
    calls run, each after an L2 flush, less the flush's own kernels (by
    name). None where the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(run):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA}

    flush_keys = device_us(flush)

    def calls():
        for _ in range(iters):
            flush()
            fn()

    us = sum(t for k, t in device_us(calls).items() if k not in flush_keys)
    return us / 1e3 / iters if us > 0 else None


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
            if w != 1:
                continue
            # timings at the decode path's shapes (w = 1)
            if name == "flash_verify":
                kv = (x["k_cache"], x["v_cache"])
            else:
                safe = x["tables"].long().clamp(0, x["k_pool"].shape[0] - 1)
                kv = tuple(p[safe].reshape(x["q"].shape[0], -1, *p.shape[2:]) for p in (x["k_pool"], x["v_pool"]))
            mask = masks[name][0][:, None]  # [b, 1, w, L]
            qt, kt, vt = x["q"].transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2)
            library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            row["ms"] = time_ms(kernel, flush)
            row["plain_ms"] = time_ms(plain, flush)
            row["library_ms"] = time_ms(library, flush)
            row["bound_ms"], row["bound_by"] = bound_ms(x, name)
            print(
                f"[kernels] {name} w=1: {row['ms']:.4f} ms (bound {row['bound_ms']:.4f} ms, "
                f"{row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
                f"library sdpa {row['library_ms']:.4f} ms"
            )
    return rows


def check_spec_kernels():
    """Kernels #6-#9 against their plain versions at the serving shape
    of check_kernels: #6 at w = 1 and 5, #7-#9 at w = 13 under a seeded
    random draft tree per row, and #7, #8 also at w = 64 (the widest tree
    ServeConfig takes), atol 1e-5. Each is timed at its path's width as
    #4 and #5 are (#6 at w = 1, the int8 decode step; the tree kernels at
    w = 13; #7 and #8 again at w = 64, printed only), with its bound
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
    timed = {("paged_flash_verify_quant", 1), *((n, 13) for n in tree_names), *((n, 64) for n in fp32_tree)}
    rows = {}
    cases = ((1, ("paged_flash_verify_quant",)), (5, ("paged_flash_verify_quant",)), (13, tree_names), (64, fp32_tree))
    for w, names in cases:
        x = kernel_inputs(device, w)
        quant = (x["q"], x["k8"], x["v8"], x["k_scale"], x["v_scale"], x["tables"], x["lengths"])
        args = {
            "paged_flash_verify_quant": quant,
            "flash_verify_tree": (x["q"], x["k_cache"], x["v_cache"], x["lengths"], x["allowed"]),
            "paged_flash_verify_tree": (x["q"], x["k_pool"], x["v_pool"], x["tables"], x["lengths"], x["allowed"]),
            "paged_flash_verify_tree_quant": quant + (x["allowed"],),
        }
        masks = visible_masks(x)
        for name in names:
            kernel = lambda fn=getattr(dk, name), a=args[name]: fn(*a)
            plain = lambda fn=getattr(dk, name + "_ref"), a=args[name]: fn(*a)
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
            if w != 64:  # the kernels line keeps the path's width
                row.update(t)
            print(
                f"[kernels] {name} w={w}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms, "
                f"{t['bound_by']}), plain {t['plain_ms']:.4f} ms, library {library}"
            )
            if name in fp32_tree:
                # time_ms counts a call's host side where it outlasts the
                # flush: the profiler's device time and the host time of
                # each call tell the two apart
                fns = {"kernel": kernel, "plain": plain, "library": sdpa}
                split = {
                    who: dict(ms=t[key], device_ms=device_ms(fn, flush), host_ms=host_ms(fn))
                    for (who, fn), key in zip(fns.items(), ("ms", "plain_ms", "library_ms"))
                }
                print("[timing] " + json.dumps(dict(name=name, w=w, **split)))
    return rows


def smi_sample() -> str:
    """The card's SM clock, its maximum, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def warm_card(seconds=2.0):
    """Keep the card busy with fp32 matrix products for `seconds`, so the
    timings that follow start at its working clock, not its idle one."""
    import torch

    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(8):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()


# -- 3. serve the flagship LM ----------------------------------------------------


def build_lm(device, layers, hidden, heads, vocab, max_seqs, max_len, seed=SEED):
    from flexflow_tpu_torch import DataType, FFConfig, FFModel
    from flexflow_tpu_torch.models import build_decoder_lm

    model = FFModel(FFConfig(batch_size=max_seqs, seed=seed))
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
    """Wrap a plain scheduler's prefill and decode so that top[rid][i] is
    (gap, first, second): the gap between the two largest logits its
    engine saw when it picked the request's i-th generated token, and
    those two tokens."""
    engine = sched.engine
    prefill, decode = engine.prefill, engine.decode

    def top2(logits):
        vals, ids = logits.topk(2, dim=-1)
        return (vals[:, 0] - vals[:, 1]).cpu().numpy(), ids.cpu().numpy()

    def prefill_rec(params, prompts, slots):
        nxt, last = prefill(params, prompts, slots)
        gaps, ids = top2(last)
        for i, s in enumerate(slots):
            top[sched.running[s].rid] = [(float(gaps[i]), *map(int, ids[i]))]
        return nxt, last

    def decode_rec(params, tokens, active):
        nxt, logits = decode(params, tokens, active)
        gaps, ids = top2(logits)
        for s in np.nonzero(active)[0]:
            top[sched.running[int(s)].rid].append((float(gaps[s]), *map(int, ids[s])))
        return nxt, logits

    engine.prefill, engine.decode = prefill_rec, decode_rec


def record_spec_top(sched, top, out):
    """Wrap a speculative scheduler's commits so that out[rid][i] is the
    gap its verify logits put between the plain run's top two tokens
    (`top`, record_top2) behind the request's i-th generated token: held
    against the plain run's own gap, the logit noise between the two
    runs' GEMM shapes."""
    from flexflow_tpu_torch.serving import accept_drafts, accept_tree

    def rows_used(logits, plan):
        if isinstance(plan, list):  # a linear draft
            return list(range(accept_drafts(logits, plan)[0] + 1))
        return [0] + [1 + n for n in accept_tree(logits, plan)[0]]

    def wrap(commit):
        def recorded(step):
            for slot, plan in step.plan.items():
                req = step.participants[slot]
                if sched.running.get(slot) is not req:
                    continue
                base = len(req.generated)
                for k, r in enumerate(rows_used(step.logits[slot], plan)):
                    if base + k < len(top[req.rid]):
                        _, t1, t2 = top[req.rid][base + k]
                        row = step.logits[slot, r]
                        out.setdefault(req.rid, {})[base + k] = float(row[t1] - row[t2])
            return commit(step)

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
    return model, summary, launches


def profile_decode(model, steps=16, label="decode", kernel=None, **serve_kw):
    """Device time by kernel over a window of `steps` scheduler
    iterations, all slots busy (torch.profiler): decode steps, or verify
    steps under a spec ServeConfig (`serve_kw`). With `kernel`, a wrapper
    of KERNEL_SYMBOLS, also that kernel's device time per wrapper call
    beside the device time of the step's GEMMs.
    None when the profiler sees no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
    from flexflow_tpu_torch.serving import Request, ServeConfig, build_scheduler

    sched, _, _ = build_scheduler(
        model, ServeConfig(max_seqs=FLAGSHIP["max_seqs"], max_seq_len=FLAGSHIP["max_len"], **serve_kw)
    )
    # a verify step may commit up to w tokens per slot
    budget = min(FLAGSHIP["max_len"] - 8, 64 * (steps + 4))
    for i in range(FLAGSHIP["max_seqs"]):
        sched.submit(Request(rid=i, prompt=[i + 1, i + 2], max_new_tokens=budget))
    sched.step()  # admission prefill + first decode, outside the window
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
        calls = dk.LAUNCHES[kernel] - calls0[kernel]
        kern_us = sum(e.self_device_time_total for e in events if any(k in e.key for k in KERNEL_SYMBOLS[kernel]))
        gemm_us = sum(e.self_device_time_total for e in events if "gemm" in e.key.lower() or "gemv" in e.key.lower())
        out["kernel"] = dict(
            name=kernel,
            calls=calls,
            device_ms_per_call=kern_us / 1e3 / calls if calls and kern_us else None,
            device_ms_per_step=kern_us / 1e3 / steps,
            gemm_ms_per_step=gemm_us / 1e3 / steps,
        )
        per_call = "not measured" if out["kernel"]["device_ms_per_call"] is None else \
            f"{out['kernel']['device_ms_per_call']:.4f} ms"
        print(f"[profile] {label}: {kernel} {per_call} of device time per call ({calls} calls, "
              f"{out['kernel']['device_ms_per_step']:.4f} ms per step) beside the step's GEMMs "
              f"{out['kernel']['gemm_ms_per_step']:.4f} ms per step")
    print("[profile] " + json.dumps(out))
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


def check_decode_logits(model, n_new=12):
    """Cached decode logits of 2 requests vs a full no-cache forward of
    prompt + generated tokens."""
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
    err = 0.0
    for i, p in enumerate(prompts):
        full = model.forward({"tokens": np.asarray([seqs[i][:-1]], dtype=np.int32)})[0]
        got = torch.stack(step_logits[i])
        err = max(err, float((got - full[len(p) - 1:]).abs().max()))
    print(f"[checks] decode logits vs full forward: max |diff| = {err:.3e} (atol {ATOL_LOGITS})")
    require(err <= ATOL_LOGITS, f"decode logits differ from the full forward by {err}")
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
    of the plain run's over the tokens before any divergence. Returns
    (near-ties as (request, token index, gap), the largest |spec gap -
    plain gap| over those tokens)."""
    ties, noise = [], 0.0
    for r in done:
        want, got = plain[r.rid], list(r.generated)
        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
        for j, g in spec_top.get(r.rid, {}).items():
            if j < i:
                noise = max(noise, abs(g - top[r.rid][j][0]))
        if got == want:
            continue
        gap = top[r.rid][i][0] if i < len(top[r.rid]) else float("inf")
        require(
            gap <= near_tie,
            f"{name}: request {r.rid} first differs from its plain stream at token {i}, "
            f"where the plain run's top two logits are {gap:.3e} apart (> {near_tie})",
        )
        print(f"[spec] {name}: request {r.rid} first differs from its plain stream at token {i}, a near-tie: "
              f"the plain run's top two logits are {gap:.3e} apart (<= {near_tie}), which the two runs' "
              f"GEMM shapes may order either way")
        ties.append((r.rid, i, gap))
    require(noise <= near_tie, f"{name}: spec and plain logit gaps differ by {noise:.3e} (> {near_tie})")
    return ties, noise


def serve_leg(name, model, layers, kernel, plain=None, **serve_kw):
    """One serving leg of SPEC_REQUESTS long requests: every request
    finishes at full length, `kernel` launches steps x layers times and
    no other decode kernel launches. A plain leg (plain=None) records its
    top two logits per token; a spec leg's streams are held against
    `plain`, (streams, top) of its plain leg. Returns (streams, top,
    summary, launches)."""
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
    near_tie = NEAR_TIE_INT8 if serve_kw.get("kv_dtype") == "int8" else NEAR_TIE
    ties, noise = compare_streams(name, done, plain[0], top, spec_top, near_tie) if spec else ([], None)
    step_s = stats.verify_s if spec else stats.decode_s
    summary = dict(
        leg=name,
        layers=layers,
        tokens=stats.tokens_generated,
        elapsed_s=stats.elapsed_s,
        tokens_per_s=stats.tokens_per_s,
        decode_steps=stats.decode_steps,
        verify_steps=stats.verify_steps,
        mean_step_ms=1e3 * step_s / steps,
        acceptance_rate=stats.acceptance_rate,
        accepted_per_verify=stats.draft_tokens_accepted / stats.verify_steps if spec else None,
        tree_nodes_per_verify=stats.tree_nodes_proposed / stats.verify_steps if spec else None,
        kv_pool_bytes=pool_bytes(cache),
        kernel=kernel,
        launches=launches[kernel],
        near_ties=len(ties),
        max_gap_noise=noise,
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
    window of (b)'s, (c)'s and (d)'s steps. Returns the launches of
    #6-#9 on their legs: (c), (e), (b) and (d)."""
    from flexflow_tpu_torch.serving import Request

    warm = lambda: [Request(rid=i, prompt=[1 + i, 2 + i], max_new_tokens=8) for i in range(4)]
    model = build_lm(device, **dict(FLAGSHIP, layers=layers))
    int8, tree_int8 = dict(kv_dtype="int8"), dict(TREE, kv_dtype="int8")
    for kw in ({}, TREE, int8, tree_int8):  # warm-up, not measured
        serve(model, warm(), **kw)
    a, a_top, *_ = serve_leg("a: plain, fp32 paged", model, layers, "paged_flash_verify")
    *_, b_launches = serve_leg("b: tree spec, fp32 paged", model, layers, "paged_flash_verify_tree",
                               plain=(a, a_top), **TREE)
    c, c_top, _, c_launches = serve_leg("c: plain, int8 paged", model, layers, "paged_flash_verify_quant", **int8)
    *_, d_launches = serve_leg("d: tree spec, int8 paged", model, layers, "paged_flash_verify_tree_quant",
                               plain=(c, c_top), **tree_int8)
    if model.device.type == "cuda":
        for label, kernel, kw in (
            ("b: tree spec verify, fp32 paged", "paged_flash_verify_tree", TREE),
            ("c: decode, int8 paged", "paged_flash_verify_quant", int8),
            ("d: tree spec verify, int8 paged", "paged_flash_verify_tree_quant", tree_int8),
        ):
            profile_decode(model, label=label, kernel=kernel, **kw)
    del model
    small = build_lm(device, **dict(FLAGSHIP, layers=small_layers))
    slot, linear_int8 = dict(kv_layout="slot"), dict(LINEAR, kv_dtype="int8")
    for kw in (slot, dict(TREE, **slot), int8, linear_int8):
        serve(small, warm(), **kw)
    s, s_top, *_ = serve_leg("plain, slot", small, small_layers, "flash_verify", **slot)
    *_, e_launches = serve_leg("e: tree spec, slot", small, small_layers, "flash_verify_tree",
                               plain=(s, s_top), **TREE, **slot)
    i, i_top, *_ = serve_leg("plain, int8 paged", small, small_layers, "paged_flash_verify_quant", **int8)
    serve_leg("f: linear spec, int8 paged", small, small_layers, "paged_flash_verify_quant",
              plain=(i, i_top), **linear_int8)
    return {
        "paged_flash_verify_quant": c_launches["paged_flash_verify_quant"],
        "flash_verify_tree": e_launches["flash_verify_tree"],
        "paged_flash_verify_tree": b_launches["paged_flash_verify_tree"],
        "paged_flash_verify_tree_quant": d_launches["paged_flash_verify_tree_quant"],
    }


# -- 5. flash kernels vs plain versions --------------------------------------------


def flash_inputs(device, b, sq, sk, h, d, causal, seed=SEED):
    """Seeded q, k, v, dO and the plain forward's (O, LSE) and delta."""
    import torch

    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    g = torch.Generator().manual_seed(seed + 7 * sq + sk + d + int(causal))
    q, k, v = (torch.randn(b, s, h, d, generator=g).to(device) for s in (sq, sk, sk))
    do = torch.randn(b, sq, h, d, generator=g).to(device)
    o, lse = fk.flash_fwd_ref(q, k, v, causal)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    return dict(q=q, k=k, v=v, do=do, o=o, lse=lse, delta=delta, causal=causal)


def flash_calls(x):
    """{kernel: (kernel call, plain call)} on the inputs x."""
    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    fwd = (x["q"], x["k"], x["v"], x["causal"])
    bwd = (x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"], x["causal"])
    return {
        "flash_fwd": (lambda: fk.flash_fwd(*fwd), lambda: fk.flash_fwd_ref(*fwd)),
        "flash_dq": (lambda: fk.flash_dq(*bwd), lambda: fk.flash_dq_ref(*bwd)),
        "flash_dkv": (lambda: fk.flash_dkv(*bwd), lambda: fk.flash_dkv_ref(*bwd)),
    }


def flash_bound_ms(x, name):
    """Least time on these inputs: every operand read once and every
    output written once at 3.35 TB/s, against the kernel's products over
    the visible (query, key) pairs (2 forward, 3 for dQ, 4 for dK/dV) at
    their fp32-accurate rate on this card: 3 TF32 passes of 2 flops per
    multiply-add at 495 TFLOP/s (3xTF32 on the dense tensor cores, 700 W),
    an effective 165 TFLOP/s, above the 67 TFLOP/s of fp32 FMAs."""
    b, sq, h, d = x["q"].shape
    sk = x["k"].shape[1]
    pairs = b * h * (sum(min(i + 1, sk) for i in range(sq)) if x["causal"] else sq * sk)
    qo, kv, rows = b * sq * h * d, b * sk * h * d, b * h * sq
    nbytes = 4 * {
        "flash_fwd": 2 * qo + 2 * kv + rows,            # q, k, v in; O, LSE out
        "flash_dq": 3 * qo + 2 * kv + 2 * rows,         # q, dO, k, v, lse, delta in; dQ out
        "flash_dkv": 2 * qo + 4 * kv + 2 * rows,        # q, dO, k, v, lse, delta in; dK, dV out
    }[name]
    flops = TF32_PASSES * {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}[name] * pairs * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / TF32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sass_opcodes(source):
    """{opcode: count} over the SASS of the library built from
    csrc/<source> (cuobjdump beside nvcc); None without cuobjdump."""
    import collections
    import re

    from flexflow_tpu_torch.ops.cuda import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    res = subprocess.run([tool, "-sass", _build.library_path(source)], capture_output=True, text=True,
                         timeout=120, check=True)
    ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", res.stdout, re.M)
    return collections.Counter(ops)


def flash_resources(d):
    """Each flash kernel's ptxas report (registers, spills, shared memory)
    at head_dim d's instantiation, its blocks per SM on this card, and
    the tensor-core instructions of each flash library's SASS."""
    from flexflow_tpu_torch.ops.cuda import _build
    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    symbol = {"flash_fwd": "flash_fwd_kernel", "flash_dq": "flash_dq_mma_kernel", "flash_dkv": "flash_dkv_mma_kernel"}
    for name, sym in symbol.items():
        source = fk.SOURCE if name == "flash_fwd" else fk.BWD_SOURCE
        occ = fk.occupancy(name, d)
        print(f"[resources] {name} at head_dim {d}: " + json.dumps(occ))
        log = _build.build_logs.get(source, "").splitlines()
        for i, line in enumerate(log):
            if "Compiling entry function" in line and sym in line:
                entry = line.split("'")[1] if "'" in line else sym
                info = [x.strip() for x in log[i + 1 : i + 4] if "registers" in x or "spill" in x]
                print(f"[resources]   ptxas {entry}: {'; '.join(info)}")
    for source in (fk.SOURCE, fk.BWD_SOURCE):
        ops = sass_opcodes(source)
        if ops is None:
            print(f"[resources] {source}: cuobjdump not found, SASS not read")
            continue
        print(f"[resources] {source}: {ops.get('HMMA', 0)} HMMA instructions in its SASS; top opcodes "
              + json.dumps(ops.most_common(14)))


def library_backend(fn) -> str:
    """Name of the device kernel that takes most of one call of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        return "not measured"
    return max(events, key=lambda e: e.self_device_time_total).key[:80]


def check_flash_kernels():
    """Kernels #1-#3 against their plain versions at the flagship training
    shape, causal and not, and ragged shapes (sq != sk both ways, head_dim
    24 and 128); times of the flagship (non-causal) case, which the
    training path runs, by the event timer and by the profiler's device
    time, beside SDPA's and the port's dense core; the kernels' resources
    at the flagship head_dim."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops import attention as attn

    device = torch.device("cuda")
    b, s, h, d = TRAIN["batch"], TRAIN["seq"], TRAIN["heads"], TRAIN["hidden"] // TRAIN["heads"]
    rows = {name: {"max_abs_err": 0.0} for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    cases = [(b, s, s, h, d, False), (b, s, s, h, d, True), (2, 500, 500, 4, 64, True), (2, 128, 384, 4, 64, True),
             (2, 384, 129, 4, 128, True), (2, 65, 200, 4, 24, False)]
    for cb, sq, sk, ch, cd, causal in cases:
        x = flash_inputs(device, cb, sq, sk, ch, cd, causal)
        for name, (kernel, plain) in flash_calls(x).items():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(float((a - r).abs().max()) for a, r in zip(got, want))
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            if name == "flash_fwd":
                ok = err <= ATOL_KERNEL
            else:
                ok = all(torch.allclose(a, r, atol=ATOL_GRAD, rtol=RTOL_GRAD) for a, r in zip(got, want))
            print(f"[kernels] {name} {(cb, sq, sk, ch, cd)} causal={causal}: max |kernel - plain| = {err:.3e}")
            require(finite and ok, f"{name} {(cb, sq, sk, ch, cd)} causal={causal}: error {err}")
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)

    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    flush = lambda: flush_buf.zero_()
    for causal in (False, True):
        x = flash_inputs(device, b, s, s, h, d, causal)
        tag = "causal" if causal else "non-causal"
        dev = {}
        for name, (kernel, plain) in flash_calls(x).items():
            ms, plain_ms = time_ms(kernel, flush), time_ms(plain, flush)
            dev[name] = device_ms(kernel, flush)
            bound, by = flash_bound_ms(x, name)
            print(f"[kernels] {name} {tag}: {ms:.4f} ms, device {dev[name]} ms (bound {bound:.4f} ms, {by}), "
                  f"plain {plain_ms:.4f} ms")
            if not causal:
                rows[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        # yardsticks, timed only: PyTorch's SDPA and the port's dense core
        qt, kt, vt, dot = (x[n].transpose(1, 2).contiguous().requires_grad_(n != "do") for n in ("q", "k", "v", "do"))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        out = sdpa()
        sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        lib_fwd, lib_bwd = time_ms(sdpa, flush), time_ms(sdpa_bwd, flush)
        lib_fwd_dev, lib_bwd_dev = device_ms(sdpa, flush), device_ms(sdpa_bwd, flush)
        qd, kd, vd = (x[n].detach().clone().requires_grad_(True) for n in ("q", "k", "v"))

        def dense():
            o = attn.scaled_dot_product_attention(qd, kd, vd, causal=causal)
            return torch.autograd.grad(o, (qd, kd, vd), x["do"])

        dense_ms = time_ms(dense, flush)
        pair = None if None in (dev["flash_dq"], dev["flash_dkv"]) else dev["flash_dq"] + dev["flash_dkv"]
        print(f"[kernels] {tag}: library SDPA forward {lib_fwd:.4f} ms, device {lib_fwd_dev} ms "
              f"({library_backend(sdpa)}), backward (#2 + #3) {lib_bwd:.4f} ms, device {lib_bwd_dev} ms "
              f"({library_backend(sdpa_bwd)}); #2 + #3 device {pair} ms; the port's dense core forward + "
              f"backward {dense_ms:.4f} ms")
        if not causal:
            rows["flash_fwd"]["library_ms"] = lib_fwd
            rows["flash_dq"]["library_ms"] = rows["flash_dkv"]["library_ms"] = lib_bwd
            rows["dense_ms"] = dense_ms
        del out
    flash_resources(d)
    return rows


# -- 6. train the flagship Transformer -------------------------------------------


def build_transformer(device, layers, hidden, heads, batch, seq, use_flash="auto", seed=SEED, **_):
    """examples/transformer.py's build_transformer, reproduced on the port:
    12 x [MHA -> dense+ReLU -> dense] -> dense(1), SGD lr 0.01, MSE."""
    from flexflow_tpu_torch import ActiMode, FFConfig, FFModel, LossType, SGDOptimizer

    model = FFModel(FFConfig(batch_size=batch, learning_rate=0.01, seed=seed))
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


def profile_train_step(model, batch):
    """Device time by kernel over one train step (torch.profiler), and
    each flash kernel's device ms and launches in it; None when the
    profiler sees no device activity."""
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
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        mine = [e for e in events if any(k in e.key for k in KERNEL_SYMBOLS[name])]
        flash[name] = (sum(e.self_device_time_total for e in mine) / 1e3, sum(e.count for e in mine))
    out = dict(
        wall_ms=1e3 * wall_s,
        device_ms=device_us / 1e3,
        device_busy_share=device_us / 1e6 / wall_s,
        flash_ms_and_launches=flash,
        top=[(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in top],
    )
    print("[profile] train step: " + json.dumps(out))
    return out


def train_flagship(device, **geo):
    """fit() over `steps` batches; each flash kernel must run once per
    layer per step and the losses stay finite."""
    import torch

    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    geo = dict(TRAIN, **geo)
    t0 = time.perf_counter()
    model = build_transformer(device, **geo)
    nparams = sum(w.numel() for ws in model.params.values() for w in ws)
    data = synthetic_batch(geo["batch"] * geo["steps"], geo["seq"], geo["hidden"])
    print(f"[train] flagship Transformer: {nparams / 1e6:.1f} M params, built in {time.perf_counter() - t0:.2f} s")
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
        for name, n in launches.items():
            require(n == geo["layers"] * steps, f"{name} launches {n} != {geo['layers']} layers x {steps} steps")
    thpt = hist[0]["throughput"]
    summary = dict(
        steps=steps,
        mean_loss=mean_loss,
        samples_per_s=thpt,
        mean_step_ms=1e3 * geo["batch"] / thpt if thpt else None,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        launches=launches,
    )
    print("[train] " + json.dumps(summary))
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


def train_causal_lm(device, layers=LM_TRAIN["layers"], steps=LM_TRAIN["steps"]):
    """The decoder LM at full width trains through fit() with sparse CE;
    each flash kernel runs once per layer per step (causal)."""
    import torch

    from flexflow_tpu_torch import DataType, FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu_torch.models import build_decoder_lm
    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    b, s, vocab = FLAGSHIP["max_seqs"], FLAGSHIP["max_len"], FLAGSHIP["vocab"]
    model = FFModel(FFConfig(batch_size=b, seed=SEED))
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
        for name, n in launches.items():
            require(n == layers * steps, f"causal LM: {name} launches {n} != {layers} x {steps}")
    print(f"[checks] causal decoder LM, {layers} layers: {steps} steps, mean loss {mean_loss:.4f} "
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
    print(f"[kernels] nvidia-smi clocks.sm, clocks.max.sm, power.draw, temperature: "
          f"at the start [{smi_idle}], after a 2 s warm-up, before the decode kernel "
          f"timings [{smi_before}], after them [{smi_sample()}]")
    model, _, main_launches = serve_flagship("cuda")
    profile_decode(model)
    del model
    model2, layout_launches = check_layouts("cuda")
    check_decode_logits(model2)
    del model2
    spec_launches = serve_spec("cuda")
    # the spec legs' recording wrappers close reference cycles around
    # their schedulers, engines and pools: free them before the training
    # phases measure peak memory
    gc.collect()
    # after the serving phases, so the decode profile stays the run's
    # first profiler session (library_backend opens one), as it was
    # before the training phases existed
    smi_before = smi_sample()
    flash_rows = check_flash_kernels()
    print(f"[kernels] nvidia-smi clocks.sm, clocks.max.sm, power.draw, temperature: "
          f"before the flash kernel timings [{smi_before}], after them [{smi_sample()}]")
    rows.update((k, v) for k, v in flash_rows.items() if k in KERNELS)
    model3, data, _, train_launches = train_flagship("cuda")
    profile_train_step(model3, {k: v[: TRAIN["batch"]] for k, v in data.items()})
    check_flash_vs_dense(model3, data)
    check_loss_falls(model3, data)
    del model3
    train_causal_lm("cuda")
    launches = {
        "paged_flash_verify": main_launches["paged_flash_verify"],
        "flash_verify": layout_launches["slot"]["flash_verify"],
        **spec_launches,
        **train_launches,
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
