#!/usr/bin/env python3
"""Ablations of bf16 flash #1's wgmma body (csrc/flash_bf16_kernel.cu,
flash_fwd_bf16_wgmma_kernel): each variant is this checkout's package with
a few string edits of csrc/, unpacked under _checkout/variants/<name>/
(git-ignored) and built there. The script reports what ptxas says of each
variant's wgmma kernels (wgmma serialization advisories, registers,
spill bytes) and the HGMMA count of its SASS, then times bf16 #1 of every
timed variant in fresh processes, in turns (the variants' order, then
reversed), by the profiler's device time (chip_smoke.device_ms, three
readings a process) at the flagship shape [8, 512, 16, 64], causal and
not. Variants that drop work (no_output_stores, no_exponentials,
no_pv_product) give wrong outputs and are timed only; the wait_* variants
are built only (what ptxas does with another mbarrier wait).

    python3 scripts/flash_fwd_bf16_variants.py [--variants NAME ...] [--rounds 2]

Needs nvcc and a CUDA device; prints one JSON line per (variant,
process, shape) and the card's name and power limit."""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "flash_bf16_kernel.cu"

# name -> [(file under csrc/, text, replacement)]; "base" is the source as it is
VARIANTS = {
    "base": [],
    "one_block_a_tile": [(SRC, "min(bh * mt, sm_count());", "bh * mt;")],
    "no_ping_pong": [(SRC, "{ hopper::bar_sync(1 + wg, 256); }", "{}"),
                     (SRC, "{ hopper::bar_arrive(1 + (wg + 1) % F::kWG, 256); }", "{}"),
                     (SRC, "if (wg == 0) hopper::bar_arrive(1, 256);", "")],
    "stages_3": [(SRC, "static constexpr int kStages = 2; ", "static constexpr int kStages = kD <= 128 ? 3 : 2; ")],
    "key_tile_64": [(SRC, "static constexpr int kN = kD <= 128 ? 128 : 64; ", "static constexpr int kN = 64; ")],
    "three_consumers": [
        (SRC, "static constexpr int kWG = 2; ", "static constexpr int kWG = kD == 64 ? 3 : 2; "),
        (SRC, "kProducerRegs = 24, kConsumerRegs = 240;\n  static_assert(kWG == 2, \"the register split is for two consumer warpgroups\");",
         "kProducerRegs = kWG == 2 ? 24 : 32, kConsumerRegs = kWG == 2 ? 240 : 160;"),
    ],
    "no_output_stores": [(SRC, "p.d,\n                      row < p.sq);", "p.d,\n                      false);")],
    "no_exponentials": [(SRC, "ok ? ex2(fmaf(s[4 * j + e], c, -mc[i])) : 0.f;", "ok ? fmaf(s[4 * j + e], c, -mc[i]) : 0.f;")],
    "no_pv_product": [(SRC, "        issue_pv<kD>(o, pa, vs + pst * kN * kD);  // ... under", "        // ... under")],
    "wait_watchdog": [("hopper.cuh", "  if (mbar_try_wait(a, parity)) return;\n  while (!mbar_try_wait(a, parity)) {\n  }",
                       "  if (mbar_try_wait(a, parity)) return;\n  const long long t0 = clock64();\n"
                       "  while (!mbar_try_wait(a, parity))\n    if (clock64() - t0 > (1ll << 35)) __trap();")],
    "wait_bare_spin": [("hopper.cuh", "  if (mbar_try_wait(a, parity)) return;\n", "")],
}
BUILD_ONLY = ("wait_watchdog", "wait_bare_spin")

TIMER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from flexflow_tpu_torch.ops.cuda import flash_kernel as fk
assert fk.__file__.startswith(sys.argv[1]), fk.__file__
flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
flush = lambda: flush_buf.zero_()
b, s, h, d = cs.TRAIN["batch"], cs.TRAIN["seq"], cs.TRAIN["heads"], cs.TRAIN["hidden"] // cs.TRAIN["heads"]
for causal in (False, True):
    x = cs.flash_inputs("cuda", b, s, s, h, d, causal, dtype=torch.bfloat16)
    fn = lambda: fk.flash_fwd(x["q"], x["k"], x["v"], causal)
    print(json.dumps({"variant": sys.argv[2], "shape": [b, s, h, d], "causal": causal,
                      "device_ms": [cs.device_ms(fn, flush) for _ in range(3)]}), flush=True)
"""


def unpack(name):
    """The package with the variant's edits under _checkout/variants/name."""
    root = os.path.join(REPO, "_checkout", "variants", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "flexflow_tpu_torch"), os.path.join(root, "flexflow_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
    for f, old, new in VARIANTS[name]:
        path = os.path.join(root, "flexflow_tpu_torch", "csrc", f)
        with open(path) as fh:
            text = fh.read()
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in csrc/{f}")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    return root


def build(name):
    """Builds the variant's bf16 library; returns (root, report lines)."""
    root = unpack(name)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from flexflow_tpu_torch.ops.cuda import _build, flash_kernel as fk; fk._bf16_lib(); "
            "print(_build.build_logs.get(fk.BF16_SOURCE, '')); print('LIB', _build.library_path(fk.BF16_SOURCE))")
    res = subprocess.run([sys.executable, "-c", code, root], capture_output=True, text=True)
    if res.returncode:
        return root, [f"{name}: build failed", res.stderr[-3000:]]
    log = res.stdout.splitlines()
    lines = [f"{name}: {line.strip()}" for line in log if "serialized" in line]
    for i, line in enumerate(log):
        if "Compiling entry function" in line and "wgmma" in line:
            tag = re.search(r"ILi(\d+)E", line).group(1)
            info = "; ".join(x.strip() for x in log[i + 1 : i + 4] if "registers" in x or "spill" in x)
            lines.append(f"{name}: wgmma kernel<{tag}>: {info}")
    lib = next(x[4:] for x in log if x.startswith("LIB "))
    sys.path.insert(0, REPO)
    from flexflow_tpu_torch.ops.cuda import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True).stdout
    for part in sass.split("Function : ")[1:]:
        fn = part.split("\n", 1)[0]
        if "wgmma" in fn:
            ops = collections.Counter(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part, re.M))
            lines.append(f"{name}: wgmma kernel<{re.search(r'ILi(\d+)E', fn).group(1)}> SASS: HGMMA {ops['HGMMA']}, "
                         f"WARPGROUP {ops['WARPGROUP']}, STL {ops['STL']}")
    return root, lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2, help="timed processes of each variant")
    args = ap.parse_args()
    with ThreadPoolExecutor(min(8, len(args.variants))) as pool:
        built = dict(zip(args.variants, pool.map(build, args.variants)))
    for name in args.variants:
        print("\n".join(built[name][1]), flush=True)
    timed = [n for n in args.variants if n not in BUILD_ONLY and "build failed" not in built[n][1][0]]
    for r in range(args.rounds):
        for name in (timed if r % 2 == 0 else timed[::-1]):
            subprocess.run([sys.executable, "-c", TIMER, built[name][0], name], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
