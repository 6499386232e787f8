#!/usr/bin/env python3
"""On-card smoke test of flexflow_tpu_torch, the PyTorch + CUDA port.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports torch, numpy and the port only, and fails (non-zero exit, no
result line) on any failed phase:

  1. build   — compiles every kernel of the serving path from csrc/ with
               nvcc for sm_90a and prints the build time and ptxas report;
  2. kernels — each kernel against its plain PyTorch version at the
               serving path's shapes (8 sequences x 16 heads x 64,
               max_len 512, 16-row pages, 256 pages; w = 1 and 5),
               atol 1e-4, with times, bounds and a library yardstick;
  3. serve   — the flagship decoder LM (12 layers, hidden 1024, 16
               heads, ff 4096, vocab 32000, seeded random weights) serves
               32 requests on 8 slots x 512 tokens under the default
               paged ServeConfig; every request must finish and the paged
               kernel must run once per layer per decode step;
  4. checks  — at 2 layers and full width: the slot and paged layouts
               give token-identical greedy streams (the slot layout runs
               the contiguous kernel), and cached decode logits match a
               full no-cache forward within 1e-3;

then prints the kernels' JSON line, the card's name and power limit, and
as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
ATOL_KERNEL = 1e-4  # fp32 kernel vs plain version: summation order only
ATOL_LOGITS = 1e-3  # cached decode vs full forward through 12 fp32 layers
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores

FLAGSHIP = dict(layers=12, hidden=1024, heads=16, vocab=32000, max_seqs=8, max_len=512)
NUM_REQUESTS = 32

# kernel wrapper -> the TPU kernel it replaces
KERNELS = {
    "flash_verify": "flexflow_tpu/ops/pallas/decode_kernel.py:235",
    "paged_flash_verify": "flexflow_tpu/ops/pallas/decode_kernel.py:342",
}


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# -- 1. build ------------------------------------------------------------------


def build_kernels():
    from flexflow_tpu_torch.ops.cuda import _build
    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk

    t0 = time.perf_counter()
    dk._lib()
    build_s = time.perf_counter() - t0
    print(f"[build] {dk.SOURCE}: {build_s:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for line in _build.build_logs.get(dk.SOURCE, "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build]   {line.strip()}")
    return build_s


# -- 2. kernels vs plain versions ----------------------------------------------


def kernel_inputs(device, w, b=8, h=16, d=64, max_len=512, page=16, num_pages=256, seed=SEED):
    """Seeded operands at the serving shapes. Lengths include 0 and
    max_len - w; block tables hold each sequence's pages in random pool
    order, sentinels past its length, one row with a sentinel hole inside
    its visible range and one dead row whose pages are all sentinels."""
    import torch

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
    return dict(
        q=f(b, w, h, d),
        k_cache=f(b, max_len, h, d),
        v_cache=f(b, max_len, h, d),
        k_pool=f(num_pages, page, h, d),
        v_pool=f(num_pages, page, h, d),
        tables=torch.from_numpy(tables).to(device),
        lengths=torch.from_numpy(lengths).to(device),
    )


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
    return {
        "flash_verify": (stair, stair.any(dim=1)),
        "paged_flash_verify": (paged_pairs, paged_pairs.any(dim=1)),
    }


def bound_ms(x, name):
    """Least time for the function on this run's inputs: each input byte
    read once (only the K/V rows some query sees), each output byte
    written once, against the flops of the two products."""
    pairs, rows = visible_masks(x)[name]
    b, w, h, d = x["q"].shape
    nbytes = 4 * (2 * b * w * h * d + b + 2 * int(rows.sum()) * h * d)
    if name == "paged_flash_verify":
        nbytes += 4 * x["tables"].numel()
    flops = 4.0 * int(pairs.sum()) * h * d
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


def serve(model, requests, **serve_kw):
    """Run `requests` to completion on a fresh scheduler; returns
    (finished requests, stats, launches per kernel during the run)."""
    import torch

    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk
    from flexflow_tpu_torch.serving import ServeConfig, build_scheduler

    cfg = dict(max_seqs=FLAGSHIP["max_seqs"], max_seq_len=FLAGSHIP["max_len"])
    cfg.update(serve_kw)
    sched, _, _ = build_scheduler(model, ServeConfig(**cfg))
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dk.reset_launches()
    done = sched.run(requests)
    launches = dict(dk.LAUNCHES)
    return done, sched.stats, launches


def serve_flagship(device, layers=FLAGSHIP["layers"]):
    from flexflow_tpu_torch.serving import Request, RequestStatus, latency_percentiles

    geo = dict(FLAGSHIP, layers=layers)
    t0 = time.perf_counter()
    model = build_lm(device, **geo)
    nparams = sum(w.numel() for ws in model.params.values() for w in ws)
    print(f"[serve] flagship LM: {nparams / 1e6:.1f} M params, built in {time.perf_counter() - t0:.2f} s")
    # warm-up (allocator, library handles); not measured
    serve(model, [Request(rid=i, prompt=[1 + i], max_new_tokens=8) for i in range(4)])
    done, stats, launches = serve(model, mixed_requests(geo["vocab"], geo["max_len"], NUM_REQUESTS))
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


def profile_decode(model, steps=16):
    """Device time by kernel over a short decode window (torch.profiler);
    None when the profiler sees no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.serving import Request, ServeConfig, build_scheduler

    sched, _, _ = build_scheduler(
        model, ServeConfig(max_seqs=FLAGSHIP["max_seqs"], max_seq_len=FLAGSHIP["max_len"])
    )
    for i in range(FLAGSHIP["max_seqs"]):
        sched.submit(Request(rid=i, prompt=[i + 1, i + 2], max_new_tokens=steps + 4))
    sched.step()  # admission prefill + first decode, outside the window
    torch.cuda.synchronize()
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
        steps=steps,
        wall_ms_per_step=1e3 * wall_s / steps,
        device_ms_per_step=device_us / 1e3 / steps,
        device_busy_share=device_us / 1e6 / wall_s,
        top=[(e.key[:60], e.self_device_time_total / 1e3 / steps, e.count // steps) for e in top],
    )
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
        done, stats, launches[layout] = serve(model, reqs, kv_layout=layout)
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
    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk

    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    build_kernels()
    rows = check_kernels()
    model, _, main_launches = serve_flagship("cuda")
    profile_decode(model)
    del model
    model2, layout_launches = check_layouts("cuda")
    check_decode_logits(model2)
    launches = {
        "paged_flash_verify": main_launches["paged_flash_verify"],
        "flash_verify": layout_launches["slot"]["flash_verify"],
    }
    for name, n in launches.items():
        require(n > 0, f"{name} was never launched on its path")
    line = {"kernels": []}
    for name, replaces in KERNELS.items():
        r = rows[name]
        line["kernels"].append(
            {
                "name": name,
                "route": "cuda",
                "source": "flexflow_tpu_torch/csrc/" + dk.SOURCE,
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
