#!/usr/bin/env python3
"""Device times of the flash kernels #1-#3 (bf16 bodies, or the fp32 ones
with --dtype float32) and of PyTorch's SDPA at the same dtype, at the
flagship training shape [8, 512, 16, 64], causal and not (or at the
shapes given), in a process that runs nothing else first.

chip_smoke.py times the same calls, but late in a long process, where the
profiler's sessions on the card read only part of their kernels now and
then (its device_ms then reports None). Here each call is read by the
profiler (chip_smoke.device_ms: the kernels of 20 calls, each after an L2
flush, less the flush's own) `--repeats` times, beside the event timer's
median (chip_smoke.time_ms, which counts a wrapper's host time where it
outlasts the flush) and the host time of one call while the card is held
busy (chip_smoke.host_ms: the wrapper's checks, allocations, tensor-map
encoding and launch). Run from the root of a checkout on a CUDA machine:

    python3 scripts/flash_bf16_device_time.py [--shape B S H D ...]
        [--causal both|no|yes] [--dtype bfloat16|float32]
        [--calls flash_fwd sdpa_fwd ...] [--root DIR]

--shape times [B, S, H, D] instead (repeatable): past head_dim 256 the
bf16 calls are the bf16 wide bodies (flash_*_wide_bf16). --calls keeps
the calls whose names start with one of the given prefixes. --root times
the kernels (and uses the timers) of another checkout, unpacked at DIR,
so that two versions compare within one chip call. It prints one JSON
line per (call, shape, causal) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--shape", type=int, nargs=4, action="append", metavar=("B", "S", "H", "D"),
                        help="a [b, s, h, d] to time (default: the flagship's)")
    parser.add_argument("--causal", choices=("both", "no", "yes"), default="both")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--calls", nargs="+", metavar="PREFIX", help="time only the calls named so")
    parser.add_argument("--root", default=ROOT, help="the checkout whose kernels are timed")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    if not torch.cuda.is_available():
        print("flash_bf16_device_time: no CUDA device is available", file=sys.stderr)
        return 2
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda load: load(), (fk._bf16_lib, fk._lib, fk._bwd_lib)))
    dtype = getattr(torch, args.dtype)
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    flagship = (cs.TRAIN["batch"], cs.TRAIN["seq"], cs.TRAIN["heads"], cs.TRAIN["hidden"] // cs.TRAIN["heads"])
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: flush_buf.zero_()
    causals = {"both": (False, True), "no": (False,), "yes": (True,)}[args.causal]
    cases = [(tuple(shape), causal) for shape in (args.shape or [flagship]) for causal in causals]
    for (b, s, h, d), causal in cases:
        x = cs.flash_inputs("cuda", b, s, s, h, d, causal, dtype=dtype)
        calls = {name: kernel for name, (kernel, _) in cs.flash_calls(x).items()}
        qt, kt, vt, dot = (x[n].transpose(1, 2).contiguous().requires_grad_(n != "do") for n in ("q", "k", "v", "do"))
        calls[f"sdpa_fwd_{tag}"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        out = calls[f"sdpa_fwd_{tag}"]()
        calls[f"sdpa_bwd_{tag}"] = lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        for name, fn in calls.items():
            if args.calls and not any(name.startswith(c) for c in args.calls):
                continue
            ms = cs.time_ms(fn, flush)
            reads = [cs.device_ms(fn, flush, top=True) for _ in range(args.repeats)]
            print(json.dumps({
                "call": name, "causal": causal, "shape": [b, s, h, d], "ms": ms,
                "device_ms": [r[0] for r in reads], "top_kernel": reads[-1][1],
                "host_ms": cs.host_ms(fn, iters=200),
            }), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
