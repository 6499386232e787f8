#!/usr/bin/env python3
"""Host time of one call of the decode-kernel wrappers at the serving
shape of chip_smoke.py (8 sequences x 16 heads x 64, max_len 512, w = 13
under a seeded draft tree): the fp32 tree verifies #7 and #8, and #5 and
#9 beside them. The card is held busy while the calls are queued, so each
reading is the wrapper's checks, allocations and launch alone.

    python3 scripts/tree_wrapper_host_time.py [--root DIR]

--root DIR times the flexflow_tpu_torch package under DIR (an unpacked
earlier commit, say) instead of this checkout's; the inputs and the timer
are this checkout's chip_smoke.py either way. Needs a CUDA device; prints
one JSON line of milliseconds per call."""

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="directory holding the flexflow_tpu_torch package to time")
    ap.add_argument("--w", type=int, default=13, help="query rows per sequence")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    from flexflow_tpu_torch.ops.cuda import decode_kernel as dk

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    x = smoke.kernel_inputs(torch.device("cuda"), args.w)
    quant = (x["q"], x["k8"], x["v8"], x["k_scale"], x["v_scale"], x["tables"], x["lengths"])
    calls = {
        "paged_flash_verify": (x["q"], x["k_pool"], x["v_pool"], x["tables"], x["lengths"]),
        "flash_verify_tree": (x["q"], x["k_cache"], x["v_cache"], x["lengths"], x["allowed"]),
        "paged_flash_verify_tree": (x["q"], x["k_pool"], x["v_pool"], x["tables"], x["lengths"], x["allowed"]),
        "paged_flash_verify_tree_quant": quant + (x["allowed"],),
    }
    out = {"package": os.path.dirname(dk.__file__), "w": args.w}
    for name, operands in calls.items():
        fn = lambda f=getattr(dk, name), a=operands: f(*a)
        out[name] = smoke.host_ms(fn, iters=200)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
