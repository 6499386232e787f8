#!/usr/bin/env python3
"""Ablations of bf16 flash #2 and #3's wgmma bodies (csrc/flash_bf16_kernel.cu,
flash_dq_bf16_wgmma_kernel and flash_dkv_bf16_wgmma_kernel): each variant is
this checkout's package with a few string edits of csrc/, unpacked under
_checkout/variants/<name>/ (git-ignored) and built there. The script reports
what ptxas says of each variant's backward kernels (wgmma serialization
advisories, registers, spill bytes) and the HGMMA count of their SASS, then,
in fresh processes, in turns (the variants' order, then reversed), times #2
and #3 by the profiler's device time (chip_smoke.device_ms, three readings a
process) at [8, 512, 16, 64] causal and not and at [8, 512, 8, 128] and
[8, 512, 4, 256], and measures their error where one key is visible (sq
300, sk 1: dQ and dK are 0 in exact arithmetic) against float64 beside the
plain version's, at head_dim 64, 128 and 256. Variants that drop work
(no_exponentials, no_output_stores) give wrong outputs and are timed only;
without the output stores ptxas also drops every product whose result goes
unused (the HGMMA count printed for each variant says how many stay), so
no_output_stores times the loads, exponentials and synchronisation alone.

    python3 scripts/flash_bwd_bf16_variants.py [--variants NAME ...] [--rounds 2]

Needs nvcc and a CUDA device; prints one JSON line per (variant, process,
shape) and the card's name and power limit."""

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
TURNS = ("{ hopper::bar_sync(1 + wg, 256); }", "{ hopper::bar_arrive(1 + (wg + 1) % F::kWG, 256); }",
         "if (wg == 0) hopper::bar_arrive(1, 256);")

# name -> [(file under csrc/, text, replacement)]; "base" is the source as it is
VARIANTS = {
    "base": [],
    # no ping-pong between the consumer warpgroups (the forward's turns go too)
    "no_ping_pong": [(SRC, TURNS[0], "{}"), (SRC, TURNS[1], "{}"), (SRC, TURNS[2], "")],
    # #2 at head_dim 64 on key tiles of 64 (128 in the body)
    "dq_key_tile_64": [(SRC, "static constexpr int kN = kD <= 64 ? 128 : 64;       // key rows of a loop tile",
                        "static constexpr int kN = 64;       // key rows of a loop tile")],
    # two and four loop-tile stages up to head_dim 128 in both kernels (three in the body)
    "stages_2": [(SRC, "static constexpr int kStages = kD <= 128 ? 3 : kD <= 192 ? 2 : 1;  // K and V",
                  "static constexpr int kStages = kD <= 192 ? 2 : 1;  // K and V"),
                 (SRC, "static constexpr int kStages = kD <= 128 ? 3 : kD <= 192 ? 2 : 1;  // Q, dO",
                  "static constexpr int kStages = kD <= 192 ? 2 : 1;  // Q, dO")],
    "stages_4": [(SRC, "static constexpr int kStages = kD <= 128 ? 3 : kD <= 192 ? 2 : 1;  // K and V",
                  "static constexpr int kStages = kD <= 128 ? 4 : kD <= 192 ? 2 : 1;  // K and V"),
                 (SRC, "static constexpr int kStages = kD <= 128 ? 3 : kD <= 192 ? 2 : 1;  // Q, dO",
                  "static constexpr int kStages = kD <= 128 ? 4 : kD <= 192 ? 2 : 1;  // Q, dO")],
    # #2 without issuing key tile j's S and dP under tile j - 1's dS K
    "dq_no_overlap": [(SRC, "static constexpr bool kOverlap = kStages > 1;        // S and dP",
                       "static constexpr bool kOverlap = false;        // S and dP")],
    # one block a work tile instead of the persistent grid
    "one_block_a_tile": [(SRC, "const int grid = min(bh * mt, sm_count());\n  flash_dq", "const int grid = bh * mt;\n  flash_dq"),
                         (SRC, "const int grid = min(tiles, sm_count());", "const int grid = tiles;")],
    # dP in one chain over head_dim (no per-box fresh accumulators)
    "dp_one_chain": [(SRC, "float(&acc)[kBRows / 2] = x == 0 ? s2 : s;", "float(&acc)[kBRows / 2] = s2;"),
                     (SRC, "hopper::desc_kmajor(b2 + x * kBRows * 64 + 16 * kk), kk > 0);",
                      "hopper::desc_kmajor(b2 + x * kBRows * 64 + 16 * kk), x + kk > 0);"),
                     (SRC, "    if (x > 0) {\n      hopper::wgmma_wait<0>();", "    if (false) {\n      hopper::wgmma_wait<0>();")],
    "no_exponentials": [(SRC, "ok ? ex2(fmaf(s[4 * j + e], c, -L[i])) : 0.f;", "ok ? fmaf(s[4 * j + e], c, -L[i]) : 0.f;"),
                        (SRC, "ok ? ex2(fmaf(s[4 * j + e], c, -L[e & 1])) : 0.f;",
                         "ok ? fmaf(s[4 * j + e], c, -L[e & 1]) : 0.f;")],
    "no_output_stores": [(SRC, "dq, half, 1.f, p.d,\n                      row < p.sq);", "dq, half, 1.f, p.d,\n                      false);"),
                         (SRC, "dk, half, 1.f, p.d - c0, row < p.sk);", "dk, half, 1.f, p.d - c0, false);"),
                         (SRC, "dv, half, 1.f, p.d - c0, row < p.sk);", "dv, half, 1.f, p.d - c0, false);")],
}
WRONG = ("no_exponentials", "no_output_stores")

TIMER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from flexflow_tpu_torch.ops.cuda import flash_kernel as fk
assert fk.__file__.startswith(sys.argv[1]), fk.__file__
name, accuracy = sys.argv[2], sys.argv[3] == "1"
flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
flush = lambda: flush_buf.zero_()
b, s = cs.TRAIN["batch"], cs.TRAIN["seq"]
for h, d, causal in ((16, 64, False), (16, 64, True), (8, 128, False), (4, 256, False)):
    x = cs.flash_inputs("cuda", b, s, s, h, d, causal, dtype=torch.bfloat16)
    args = (x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"], causal)
    print(json.dumps({"variant": name, "shape": [b, s, h, d], "causal": causal,
                      "dq_ms": [cs.device_ms(lambda: fk.flash_dq(*args), flush) for _ in range(3)],
                      "dkv_ms": [cs.device_ms(lambda: fk.flash_dkv(*args), flush) for _ in range(3)]}), flush=True)
for d in (64, 128, 256) if accuracy else ():
    errs = {}
    for causal in (False, True):
        x = cs.flash_inputs("cuda", 2, 300, 1, 3, d, causal, dtype=torch.bfloat16)
        args = (x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"], causal)
        ex = [x[n].double() for n in ("q", "k", "v", "do")] + [x["lse"], x["delta"], causal]
        got = (fk.flash_dq(*args), *fk.flash_dkv(*args))
        plain = (fk.flash_dq_ref(*args), *fk.flash_dkv_ref(*args))
        exact = (fk.flash_dq_ref(*ex), *fk.flash_dkv_ref(*ex))
        for out, a, p, e in zip(("dQ", "dK"), got, plain, exact):
            errs.setdefault(out, []).append([float((a.double() - e).abs().max()), float((p.double() - e).abs().max())])
    print(json.dumps({"variant": name, "accuracy_sk1_head_dim": d, "kernel_and_plain_err_vs_float64": errs}), flush=True)
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
    lines = [f"{name}: {line.strip()[:200]}" for line in log if "serialized" in line]
    for i, line in enumerate(log):
        m = re.search(r"(flash_d(?:q|kv)_bf16_wgmma_kernel)ILi(\d+)E", line)
        if "Compiling entry function" in line and m:
            info = "; ".join(x.strip() for x in log[i + 1 : i + 4] if "registers" in x or "spill" in x)
            lines.append(f"{name}: {m.group(1)}<{m.group(2)}>: {info}")
    lib = next(x[4:] for x in log if x.startswith("LIB "))
    sys.path.insert(0, REPO)
    from flexflow_tpu_torch.ops.cuda import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True).stdout
    for part in sass.split("Function : ")[1:]:
        m = re.search(r"(flash_d(?:q|kv)_bf16_wgmma_kernel)ILi(\d+)E", part.split("\n", 1)[0])
        if m:
            ops = collections.Counter(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part, re.M))
            lines.append(f"{name}: {m.group(1)}<{m.group(2)}> SASS: HGMMA {ops['HGMMA']}, "
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
    timed = [n for n in args.variants if "build failed" not in built[n][1][0]]
    for r in range(args.rounds):
        for name in (timed if r % 2 == 0 else timed[::-1]):
            accuracy = "1" if r == 0 and name not in WRONG else "0"
            subprocess.run([sys.executable, "-c", TIMER, built[name][0], name, accuracy], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
