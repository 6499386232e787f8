#!/usr/bin/env python3
"""A/B of flash kernel #1's P V accumulation on the card.

Builds csrc/flash_kernel.cu as committed (each 16 keys' part of O in a
fresh accumulator, added to O in fp32: accumulate_pv) and a variant of it
whose P V runs in one chain of mma's into O for the whole key loop (PR 6's
first body: product_pn with O as both accumulators), then times both in
turns (committed, variant, variant, committed) at the flagship training
shape [8, 512, 16, 64], causal and not, each call after an L2 flush, and
prints each one's largest error against the plain version, its registers
and blocks per SM. Run from the root of a checkout on a CUDA machine:

    python3 scripts/flash_fwd_fresh_ab.py

It prints one JSON line per (variant, causal, turn) and the card's name
and power limit.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

COMMITTED = "accumulate_pv<kOT>(s, vt, o, cn);  // O += P V"
ONE_CHAIN = "product_pn<kOT, kNT / 2, 2>(s, vt, o, s + 1, vt + 8 * vld, o, cn);"


def build(csrc_text: str, header: str):
    """Load flash_kernel.cu built from csrc_text beside a copy of header."""
    from flexflow_tpu_torch.ops.cuda import _build
    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    d = tempfile.mkdtemp(prefix="flash_fwd_ab_")
    with open(os.path.join(d, fk.SOURCE), "w") as f:
        f.write(csrc_text)
    shutil.copy(header, d)
    _build.CSRC = d
    _build._loaded.pop(fk.SOURCE, None)
    fk._bound = None
    return fk._lib()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_fwd_fresh_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from flexflow_tpu_torch.ops.cuda import _build
    from flexflow_tpu_torch.ops.cuda import flash_kernel as fk

    with open(os.path.join(_build.CSRC, fk.SOURCE)) as f:
        src = f.read()
    if COMMITTED not in src:
        print("flash_fwd_fresh_ab: csrc/flash_kernel.cu no longer calls accumulate_pv", file=sys.stderr)
        return 2
    header = os.path.join(_build.CSRC, "flash_common.cuh")
    libs = {"committed": build(src, header), "one_chain": build(src.replace(COMMITTED, ONE_CHAIN), header)}
    cs.warm_card()
    dev = torch.device("cuda")
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    flush = lambda: flush_buf.zero_()
    for causal in (False, True):
        x = cs.flash_inputs(dev, 8, 512, 512, 16, 64, causal)
        ro, rl = fk.flash_fwd_ref(x["q"], x["k"], x["v"], causal)
        call = lambda: fk.flash_fwd(x["q"], x["k"], x["v"], causal)
        for turn, name in enumerate(("committed", "one_chain", "one_chain", "committed")):
            fk._bound = libs[name]
            o, lse = call()
            err = max(float((o - ro).abs().max()), float((lse - rl).abs().max()))
            print(json.dumps(dict(variant=name, causal=causal, turn=turn, ms=cs.time_ms(call, flush),
                                  device_ms=cs.device_ms(call, flush), max_abs_err=err,
                                  **fk.occupancy("flash_fwd", 64))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
