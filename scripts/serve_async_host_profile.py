#!/usr/bin/env python3
"""Where the host time of a serving step goes, in the synchronous loop
and in the async double-buffered one (ServeConfig.serve_async).

In one process on a CUDA card, the full-width flagship decoder LM of
chip_smoke.py (12 layers, hidden 1024, 16 heads, vocab 32000, 8 slots x
512 tokens, random weights from the seed) serves a leg of chip_smoke.py's
phase 4f with each loop: `--leg a` phase 3's burst (32 mixed requests,
greedy, or sampled with `--temperature`), `--leg c` phase 4e (b)'s
traffic chunked on int8 pools under optimistic admission at 72 pages.
First `--turns` timed runs in turns (sync, async, async, sync, ...), then
one run of each under cProfile. Run from the root of a checkout:

    python3 scripts/serve_async_host_profile.py [--leg a] [--layers 12] [--turns 2] [--top 30] [--temperature 0.8]

It prints the card's name and power limit, one JSON line a timed run
(tokens/s, ms a decode step, the time blocked at reconciles), and for
the profiled runs the functions whose own time per step (decode and chunk steps) differs
most between the loops, with each loop's own and cumulative ms a step.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs
    from flexflow_tpu_torch.serving import ServeConfig, build_scheduler

    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=cs.FLAGSHIP["layers"])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--leg", choices=("a", "c"), default="a")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_async_host_profile: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    model = cs.build_lm("cuda", **dict(cs.FLAGSHIP, layers=args.layers))
    kw = dict(temperature=args.temperature, seed=cs.FEATURE_SEED) if args.temperature else {}
    if args.leg == "c":
        kw.update(kv_dtype="int8", admission="optimistic", kv_pages=cs.ASYNC_PAGES_CHUNKED, **cs.CHUNKED)
        requests = lambda: cs.feature_requests(cs.FLAGSHIP["vocab"])
    else:
        requests = lambda: cs.mixed_requests(cs.FLAGSHIP["vocab"], cs.FLAGSHIP["max_len"], cs.NUM_REQUESTS)

    def run(serve_async, profiler=None):
        sched, _, _ = build_scheduler(model, ServeConfig(max_seqs=cs.FLAGSHIP["max_seqs"],
                                                         max_seq_len=cs.FLAGSHIP["max_len"],
                                                         serve_async=serve_async, **kw))
        reqs = requests()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profiler is not None:
            profiler.enable()
        done = sched.run(reqs)
        torch.cuda.synchronize()
        if profiler is not None:
            profiler.disable()
        elapsed = time.perf_counter() - t0
        cs.require(all(r.ok for r in done), "a request did not finish")
        stats = sched.stats
        stats.steps = stats.decode_steps + stats.chunk_steps
        return stats, elapsed, {r.rid: list(r.generated) for r in done}

    run(False)  # warm-up: the kernels' builds, the allocators
    run(True)
    streams = {}
    for turn in range(args.turns):
        for mode in (("sync", "async") if turn % 2 == 0 else ("async", "sync")):
            stats, elapsed, got = run(mode == "async")
            cs.require(streams.setdefault(mode, got) == got and got == streams.get("sync", got),
                       f"{mode}: the streams changed")
            print("RUN " + json.dumps(dict(mode=mode, turn=turn, tokens_per_s=stats.tokens_generated / elapsed,
                                           ms_per_step=1e3 * elapsed / stats.steps, steps=stats.steps,
                                           preemptions=stats.preemptions,
                                           commit_wait_ms_per_step=1e3 * stats.commit_wait_s / stats.steps,
                                           overlap_fraction=stats.overlap_fraction)))
    per_step = {}
    for mode in ("sync", "async"):
        prof = cProfile.Profile()
        stats, elapsed, _ = run(mode == "async", prof)
        ps = pstats.Stats(prof)
        per_step[mode] = {
            f"{os.path.relpath(k[0], ROOT) if k[0].startswith(ROOT) else os.path.basename(k[0])}:{k[1]}:{k[2]}":
            (v[2] * 1e3 / stats.steps, v[3] * 1e3 / stats.steps, v[1])
            for k, v in ps.stats.items()
        }
        print("PROFILED " + json.dumps(dict(mode=mode, ms_per_step=1e3 * elapsed / stats.steps, steps=stats.steps)))
    names = set(per_step["sync"]) | set(per_step["async"])
    zero = (0.0, 0.0, 0)
    diff = sorted(names, key=lambda n: -abs(per_step["async"].get(n, zero)[0] - per_step["sync"].get(n, zero)[0]))
    print("own ms a step, sync / async; cumulative ms a step, sync / async; calls, sync / async; function")
    for n in diff[: args.top]:
        s, a = per_step["sync"].get(n, zero), per_step["async"].get(n, zero)
        print(f"{s[0]:8.4f} {a[0]:8.4f}   {s[1]:8.4f} {a[1]:8.4f}   {s[2]:7d} {a[2]:7d}   {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
