#!/usr/bin/env python3
"""Ablations of bf16 flash #1's wide wgmma body past head_dim 256
(csrc/flash_bf16_kernel.cu, flash_fwd_wide_bf16_wgmma_kernel): each
variant is this checkout's package with a few string edits of csrc/,
unpacked under _checkout/variants/<name>/ (git-ignored) and built there.
The script reports what ptxas says of each variant's wide kernels (wgmma
serialization advisories, registers, spill bytes) and the HGMMA count of
their SASS, then times bf16 #1 of every variant in fresh processes, in
turns (the variants' order, then reversed), by the profiler's device time
(chip_smoke.device_ms, three readings a process) at [8, 512, 4, 320]
(causal and not) and [8, 256, 2, 512].

    python3 scripts/flash_fwd_wide_bf16_variants.py [--variants NAME ...] [--rounds 2]

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

# hopper::WgmmaSS at N = 32 (the key_tile_32 variant's score product)
WGMMA_SS_32 = r"""template <int kTA, int kTB>
struct WgmmaSS<32, kTA, kTB> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
  }
};

"""

# name -> [(file under csrc/, text, replacement)]; "base" is the source as it is
VARIANTS = {
    "base": [],
    # output chunks of up to 320 columns (5 boxes): one score pass at head_dim 320, 160 f32 of O a thread
    "chunks_320": [(SRC, "static constexpr int kMaxBoxes = 4; ", "static constexpr int kMaxBoxes = 5; "),
                   (SRC, "constexpr int kWideResidentD = 640;", "constexpr int kWideResidentD = 576;"),
                   (SRC, "(void*)flash_fwd_wide_bf16_wgmma_kernel<4>};", "(void*)flash_fwd_wide_bf16_wgmma_kernel<4>,\n"
                    "      (void*)flash_fwd_wide_bf16_wgmma_kernel<5>};"),
                   (SRC, "static void* const table[3] = {", "static void* const table[4] = {"),
                   (SRC, "    default: return launch_wide_at<4>(p, w, maps, stream);",
                    "    case 4: return launch_wide_at<4>(p, w, maps, stream);\n"
                    "    default: return launch_wide_at<5>(p, w, maps, stream);")],
    # key tiles of 32 keys, with the m64n32k16 SS product they need
    "key_tile_32": [(SRC, "static constexpr int kN = 64;                     // key rows",
                     "static constexpr int kN = 32;                     // key rows"),
                    (SRC, "constexpr int kWideResidentD = 640;", "constexpr int kWideResidentD = 768;"),
                    ("hopper.cuh", "template <int kTA, int kTB>\nstruct WgmmaSS<64, kTA, kTB> {",
                     WGMMA_SS_32 + "template <int kTA, int kTB>\nstruct WgmmaSS<64, kTA, kTB> {")],
    # a ring of at most 10 slots (at 320 the base takes 18, at 512 12)
    "ring_10": [(SRC, "static constexpr int kMaxSlots = 32; ", "static constexpr int kMaxSlots = 10; ")],
    # the fewest chunks, as even as they come, whatever the grid (at [8, 256, 2, 512]: 2 chunks of 256, not 4 of 128)
    "chunks_even": [(SRC, "  for (int kb = Wide::kMaxBoxes; kb >= 2; --kb) {",
                     "  for (int kb = Wide::kMaxBoxes; kb >= (nb + (nb + 3) / 4 - 1) / ((nb + 3) / 4); --kb) {")],
    # the consumers issue their products in turns on named barriers, as the body up to 256 does, where the
    # ring holds what a turn waits for (V(j - 1) and all of K(j))
    "ping_pong": [(SRC, "    const int chains = (nb + kC - 1) / kC;  // at least 2: nb > kC past kStagedD\n",
                   "    const int chains = (nb + kC - 1) / kC;  // at least 2: nb > kC past kStagedD\n"
                   "    const bool pp = resident && ns >= nb + kB;\n"
                   "    if (pp && wg == 0) hopper::bar_arrive(1, 256);\n"),
                  (SRC, "        int freed = 0;  // K boxes of tile j this warpgroup is done with\n",
                   "        int freed = 0;  // K boxes of tile j this warpgroup is done with\n"
                   "        if (pp) hopper::bar_sync(1 + wg, 256);\n"),
                  (SRC, "        hopper::wgmma_wait<0>();\n#pragma unroll\n        for (int b = 0; b < kB; ++b) hopper::fence_regs(o[b]);\n"
                        "        if (j == n) {",
                   "        if (pp) hopper::bar_arrive(2 - wg, 256);\n"
                   "        hopper::wgmma_wait<0>();\n#pragma unroll\n        for (int b = 0; b < kB; ++b) hopper::fence_regs(o[b]);\n"
                   "        if (j == n) {")],
}
SHAPES = ((8, 512, 4, 320, False), (8, 512, 4, 320, True), (8, 256, 2, 512, False))

TIMER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from flexflow_tpu_torch.ops.cuda import flash_kernel as fk
assert fk.__file__.startswith(sys.argv[1]), fk.__file__
flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
flush = lambda: flush_buf.zero_()
for b, s, h, d, causal in json.loads(sys.argv[3]):
    x = cs.flash_inputs("cuda", b, s, s, h, d, causal, dtype=torch.bfloat16)
    fn = lambda: fk.flash_fwd(x["q"], x["k"], x["v"], causal)
    o, lse = fn()
    want = fk.flash_fwd_ref(x["q"], x["k"], x["v"], causal)
    err = float((o.float() - want[0].float()).abs().max())
    print(json.dumps({"variant": sys.argv[2], "shape": [b, s, h, d], "causal": causal, "max_abs_err": err,
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
    lines = [f"{name}: ptxas {re.search(r'C7\d+', line).group(0)}, wgmma serialized in wide kernel<"
             f"{re.search(r'wide_bf16_wgmma_kernelILi(\d+)E', line).group(1)}>"
             for line in log if "serialized" in line and "wide_bf16" in line]
    for i, line in enumerate(log):
        if "Compiling entry function" in line and "wide_bf16" in line:
            tag = re.search(r"ILi(\d+)E", line).group(1)
            info = "; ".join(x.strip() for x in log[i + 1 : i + 4] if "registers" in x or "spill" in x)
            lines.append(f"{name}: wide kernel<{tag}>: {info}")
    lib = next(x[4:] for x in log if x.startswith("LIB "))
    sys.path.insert(0, REPO)
    from flexflow_tpu_torch.ops.cuda import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True).stdout
    for part in sass.split("Function : ")[1:]:
        fn = part.split("\n", 1)[0]
        if "wide_bf16" in fn:
            ops = collections.Counter(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part, re.M))
            lines.append(f"{name}: wide kernel<{re.search(r'ILi(\d+)E', fn).group(1)}> SASS: HGMMA {ops['HGMMA']}, "
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
            res = subprocess.run([sys.executable, "-c", TIMER, built[name][0], name, json.dumps(SHAPES)], timeout=600)
            if res.returncode:
                print(json.dumps({"variant": name, "failed": res.returncode}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
