#!/usr/bin/env python3
"""Device times of the bf16 flash kernels #1-#3 and of PyTorch's bf16 SDPA
at the flagship training shape [8, 512, 16, 64], causal and not (or at
the shapes given), in a process that runs nothing else first.

chip_smoke.py times the same calls, but late in a long process, where the
profiler's sessions on the card read only part of their kernels now and
then (its device_ms then reports None). Here each call is read by the
profiler (chip_smoke.device_ms: the kernels of 20 calls, each after an L2
flush, less the flush's own) `--repeats` times, beside the event timer's
median (chip_smoke.time_ms, which counts a wrapper's host time where it
outlasts the flush). Run from the root of a checkout on a CUDA machine:

    python3 scripts/flash_bf16_device_time.py [--shape B S H D ...]

--shape times [B, S, H, D] instead (repeatable): past head_dim 256 the
calls are the bf16 wide kernels (flash_*_wide_bf16). It prints one JSON
line per (call, shape, causal) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--shape", type=int, nargs=4, action="append", metavar=("B", "S", "H", "D"),
                        help="a [b, s, h, d] to time (default: the flagship's)")
    parser.add_argument("--causal", choices=("both", "no"), default="both")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_bf16_device_time: no CUDA device is available", file=sys.stderr)
        return 2
    fk._bf16_lib()
    fk._lib()
    fk._bwd_lib()
    flagship = (cs.TRAIN["batch"], cs.TRAIN["seq"], cs.TRAIN["heads"], cs.TRAIN["hidden"] // cs.TRAIN["heads"])
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: flush_buf.zero_()
    cases = [(tuple(shape), causal) for shape in (args.shape or [flagship])
             for causal in ((False, True) if args.causal == "both" else (False,))]
    for (b, s, h, d), causal in cases:
        x = cs.flash_inputs("cuda", b, s, s, h, d, causal, dtype=torch.bfloat16)
        calls = {name: kernel for name, (kernel, _) in cs.flash_calls(x).items()}
        qt, kt, vt, dot = (x[n].transpose(1, 2).contiguous().requires_grad_(n != "do") for n in ("q", "k", "v", "do"))
        calls["sdpa_fwd_bf16"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        out = calls["sdpa_fwd_bf16"]()
        calls["sdpa_bwd_bf16"] = lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        for name, fn in calls.items():
            ms = cs.time_ms(fn, flush)
            reads = [cs.device_ms(fn, flush, top=True) for _ in range(args.repeats)]
            print(json.dumps({
                "call": name, "causal": causal, "shape": [b, s, h, d], "ms": ms,
                "device_ms": [r[0] for r in reads], "top_kernel": reads[-1][1],
            }), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
