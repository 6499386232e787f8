#!/usr/bin/env python3
"""Host time of the small host/device copies a serving step makes, on a
CUDA card with the device idle: the synchronous copies the engine made
before its dispatch / reconcile split (a pageable copy_ into a device
buffer, .cpu()) against the pieces of the split's (a pinned snapshot,
a non_blocking copy from it, a pinned read-back buffer, an event), at
the decode step's sizes (the core's int32 inputs for 8 slots of 32
pages, its [3, 8] read-back). Run from the root of a checkout:

    python3 scripts/host_copy_costs.py [--iters 2000]

It prints the card's name and power limit, then one JSON line: the mean
microseconds of host time per call of each piece.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("host_copy_costs: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    S, cols = 8, 32
    host = np.arange(5 * S + 1 + S * cols, dtype=np.int32)
    inp = torch.empty(host.size, dtype=torch.int32, device=dev)
    out = torch.zeros((3, S), dtype=torch.int32, device=dev)
    pinned_in = torch.empty(host.size, dtype=torch.int32, pin_memory=True)
    pinned_out = torch.empty((3, S), dtype=torch.int32, pin_memory=True)
    pieces = {
        "pageable_copy_to_device": lambda: inp.copy_(torch.from_numpy(host)),
        "cpu_read": lambda: out.cpu().numpy(),
        "pin_memory_snapshot": lambda: torch.from_numpy(np.array(host)).pin_memory(),
        "pinned_snapshot_and_copy": lambda: inp.copy_(torch.from_numpy(np.array(host)).pin_memory(),
                                                      non_blocking=True),
        "reused_pinned_and_copy": lambda: inp.copy_(pinned_in.copy_(torch.from_numpy(host)), non_blocking=True),
        "empty_pinned": lambda: torch.empty((3, S), dtype=torch.int32, pin_memory=True),
        "event_record": lambda: torch.cuda.Event().record(),
        "readback_fresh_pinned_event_wait": lambda: _readback(torch.empty((3, S), dtype=torch.int32,
                                                                          pin_memory=True), out),
        "readback_reused_pinned_event_wait": lambda: _readback(pinned_out, out),
    }
    res = {}
    for name, fn in pieces.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        res[name] = 1e6 * (time.perf_counter() - t0) / args.iters
        torch.cuda.synchronize()
    print(json.dumps({"host_us_per_call": res}))
    return 0


def _readback(host, dev):
    import torch

    host.copy_(dev, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host.numpy()


if __name__ == "__main__":
    sys.exit(main())
