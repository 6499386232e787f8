#!/usr/bin/env python3
"""Training-step times of the flagship Transformer in fp32 and under mixed
precision (chip_smoke.py's phases 6 and 6b), in a process that runs
nothing else first, so that two checkouts compare within one chip call.

For each mode it runs chip_smoke.train_flagship (the 10-step fit();
samples/s and mean step ms as phase 6 / 6b print them), then
chip_smoke.profile_train_step on one batch (wall and device ms of one
profiled step, the device's busy share), then `--steps` more train steps
each timed on the host clock with the card synchronized (their median).
Run from the root of a checkout on a CUDA machine, one process per
checkout and turn:

    for r in _checkout/parent . . _checkout/parent; do
        python3 scripts/train_step_ab.py --root $r; done

--root takes the port and chip_smoke.py of another checkout, unpacked at
DIR (its kernels build there at first use). Prints one JSON line per
mode and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=ROOT, help="the checkout whose port is timed")
    parser.add_argument("--modes", nargs="+", choices=("fp32", "mixed"), default=["fp32", "mixed"])
    parser.add_argument("--steps", type=int, default=20, help="train steps timed on the host clock")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke as cs
    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    if not torch.cuda.is_available():
        print("train_step_ab: no CUDA device is available", file=sys.stderr)
        return 2
    assert fk.__file__.startswith(root), fk.__file__
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda load: load(), (fk._bf16_lib, fk._lib, fk._bwd_lib)))
    cs.warm_card()
    for mode in args.modes:
        model, data, summary, _ = cs.train_flagship("cuda", mixed=mode == "mixed")
        batch = {k: v[: cs.TRAIN["batch"]] for k, v in data.items()}
        prof = cs.profile_train_step(model, batch) or {}
        step = model.executor.train_step()
        tensors = model.executor.shard_batch(batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            model.params, model.opt_state, _, _ = step(model.params, model.opt_state, tensors, 0)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        print(json.dumps({
            "root": args.root, "mode": mode, "samples_per_s": summary["samples_per_s"],
            "mean_step_ms": summary["mean_step_ms"], "profiled_wall_ms": prof.get("wall_ms"),
            "profiled_device_ms": prof.get("device_ms"), "device_busy_share": prof.get("device_busy_share"),
            "median_step_ms": statistics.median(times), "step_ms": times,
        }), flush=True)
        del model, data
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
