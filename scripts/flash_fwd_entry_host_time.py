#!/usr/bin/env python3
"""Host time of one call of bf16 flash #1's C entry point
(`ff_flash_fwd_bf16`: tensor-map encoding where the body uses TMA, and
the launch) in this checkout's library and in another checkout's, in
turns in one process, at the flagship training shape [8, 512, 16, 64].
The card is held busy by a spin queued first, so no call waits on the
device; the Python wrapper's checks and allocations, common to both, are
left out, so that a difference of a few microseconds shows above the
wrapper's spread between processes.

    python3 scripts/flash_fwd_entry_host_time.py --root DIR [--iters N]

DIR holds the other checkout (an unpacked earlier commit, say). Needs a
CUDA device; prints one JSON line of microseconds per call (median of
each library's calls, and each round's medians)."""

import argparse
import ctypes
import importlib.util
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_lib(root):
    """The bf16 flash library of the checkout at root, built there by its
    own _build module, with ff_flash_fwd_bf16's C signature."""
    spec = importlib.util.spec_from_file_location(
        f"_build_{abs(hash(root))}", os.path.join(root, "flexflow_tpu_torch", "ops", "cuda", "_build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    lib = build.load("flash_bf16_kernel.cu")
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.ff_flash_fwd_bf16.argtypes = [P] * 5 + [I] * 5 + [L] * 9 + [F, I, P]
    lib.ff_flash_fwd_bf16.restype = I
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the other checkout")
    ap.add_argument("--iters", type=int, default=200, help="calls per library per round")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    libs = {"this": load_lib(REPO), "other": load_lib(os.path.abspath(args.root))}
    b, s, h, d = 8, 512, 16, 64
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g).to("cuda", torch.bfloat16) for _ in range(3))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        return lib.ff_flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                     b, h, s, s, d, *strides, d ** -0.5, 0, stream)

    for lib in libs.values():  # configure, warm up
        assert call(lib) == 0
    torch.cuda.synchronize()
    out = {name: [] for name in libs}
    for r in range(args.rounds):
        for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
            lib = libs[name]
            torch.cuda._sleep(200_000_000)  # hold the card while the calls are queued
            times = []
            for _ in range(args.iters):
                t0 = time.perf_counter()
                call(lib)
                times.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            out[name].append(1e6 * float(np.median(times)))
    print(json.dumps({"shape": [b, s, h, d], "us_per_call": {n: float(np.median(x)) for n, x in out.items()},
                      "rounds": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
