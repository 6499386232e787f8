#!/usr/bin/env python3
"""Ablations of fp32 flash #1's wide body (csrc/flash_kernel.cu,
flash_fwd_wide_kernel, head_dim past 128): each variant is this
checkout's package with a few string edits of csrc/flash_kernel.cu,
unpacked under _checkout/variants/<name>/ (git-ignored) and built there.
The script reports what ptxas says of each variant's wide kernels
(registers, spill bytes), then times fp32 #1 of every variant in fresh
processes, in turns (the variants' order, then reversed), by the
profiler's device time (chip_smoke.device_ms, three readings a process)
at [8, 512, 4, 256], [8, 512, 4, 320] and [8, 256, 2, 512] non-causal and
[8, 512, 4, 320] causal, each with its largest error against the plain
version at the timed shape. The variants:

  base              the body as it is (a ring of up to 8 slots, as many as
                    shared memory leaves)
  stages_2          a ring of 2 slots
  stages_3          a ring of 3 slots
  split_once        Q resident as split fragments (big and small, 64 d
                    floats in place of 32 d; resident up to 608), read with
                    16-byte loads and not split again at every key tile
  piece_256         ring items of 256 columns (8 boxes: 4 k-steps and 4 V
                    n-tiles of a warp an item; Q resident up to 960)
  cp_async_ring     the ring filled by the producer warp with cp.async
                    (mbarrier arrivals by cp.async.mbarrier.arrive) in
                    place of TMA
  no_v_copies       diagnostic, wrong output: V's pieces not copied (half
                    the ring's traffic from L2), V read as it lies
  no_score_product  diagnostic, wrong output: the score mma's left out
                    (ptxas then drops the Q and K fragment reads too)
  no_pv_product     diagnostic, wrong output: the P V mma's left out
                    (and the V and P fragment reads)

    python3 scripts/flash_fwd_fp32_variants.py [--variants NAME ...] [--rounds 2]

Needs nvcc and a CUDA device; prints one JSON line per (variant,
process, shape) and the card's name and power limit."""

import argparse
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "flash_kernel.cu"

# the producer's TMA loads of an item, and the cp_async_ring variant's
# copies in their place: all 32 lanes of the producer warp copy the boxes
# into their swizzled layout with cp.async and arrive on the full barrier
# when their copies land
_TMA_LOADS = """        // a box past the tensor's rows or columns arrives zero-filled
        hopper::mbar_expect_tx(&full[slot], (with_q ? 2 : 1) * boxes * kBox * 4);
        for (int b = 0; b < boxes; ++b) {
          hopper::tma_load_4d(dst + b * kBox, score ? &tk : &tv, &full[slot], col + 32 * b, k0, ih, ib);
          if (with_q)
            hopper::tma_load_4d(dst + (kPieceBoxes + b) * kBox, &tq, &full[slot], col + 32 * b, q0, ih, ib);
        }
"""
_CP_ASYNC_LOADS = """        {
          const float* src[2] = {score ? p.k + ib * p.k_sb + ih * p.k_sh : p.v + ib * p.v_sb + ih * p.v_sh,
                                 p.q + ib * p.q_sb + ih * p.q_sh};
          const int64_t stride[2] = {score ? p.k_ss : p.v_ss, p.q_ss};
          const int row0[2] = {k0, q0}, rows[2] = {p.sk, p.sq};
          for (int o = 0; o < (with_q ? 2 : 1); ++o)
            for (int b = 0; b < boxes; ++b)
              for (int i = lane; i < kBox / 4; i += 32) {
                const int r = i >> 3, c = 4 * (i & 7), cg = col + 32 * b + c;
                const bool in = row0[o] + r < rows[o] && cg < d;
                cp_async(dst + (o * kPieceBoxes + b) * kBox + swz(r, c),
                         in ? src[o] + (int64_t)(row0[o] + r) * stride[o] + cg : src[o], 16, in);
              }
          asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(hopper::smem_u32(&full[slot]))
                       : "memory");
        }
"""

# the split_once variant's resident Q: stored split as it is staged, and
# read as split fragments in place of the float4 read and split
_Q_STORE = """      float* f = qf + ((c >> 3) * 2 + (r >> 4)) * kFrag + 16 * (r & 7) + ((r >> 3) & 1) + 2 * ((c >> 2) & 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) f[4 * e] = x[e];
"""
_Q_STORE_SPLIT = """      float* f = qf + ((c >> 3) * 2 + (r >> 4)) * 2 * kFrag + 16 * (r & 7) + ((r >> 3) & 1) + 2 * ((c >> 2) & 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t big, small;
        split(x[e], big, small);
        f[4 * e] = __uint_as_float(big);
        f[4 * e + kFrag] = __uint_as_float(small);
      }
"""
_Q_READ = """              const float4 x = *reinterpret_cast<const float4*>(
                  qf + ((pc * (kPieceCols / 8) + kk) * 2 + mt) * kFrag + 4 * lane);
              a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
"""
_Q_READ_SPLIT = """              const float* fa = qf + ((pc * (kPieceCols / 8) + kk) * 2 + mt) * 2 * kFrag + 4 * lane;
              get_a<false>(fa, fa + kFrag, ab[mt], as[mt]);
              continue;
"""

# name -> [(file under csrc/, text, replacement)]; "base" is the source as it is
VARIANTS = {
    "base": [],
    "stages_2": [(SRC, "constexpr int kMaxStages = 8;", "constexpr int kMaxStages = 2;")],
    "stages_3": [(SRC, "constexpr int kMaxStages = 8;", "constexpr int kMaxStages = 3;")],
    "split_once": [(SRC, "(resident ? 32 * d : 0)", "(resident ? 64 * d : 0)"),
                   (SRC, "(kResident ? 32 * p.d : 0)", "(kResident ? 64 * p.d : 0)"),
                   (SRC, "constexpr int kWResidentD = 1216;", "constexpr int kWResidentD = 608;"),
                   (SRC, _Q_STORE, _Q_STORE_SPLIT), (SRC, _Q_READ, _Q_READ_SPLIT)],
    "piece_256": [(SRC, "constexpr int kPieceBoxes = 4;", "constexpr int kPieceBoxes = 8;"),
                  (SRC, "constexpr int kWResidentD = 1216;", "constexpr int kWResidentD = 960;")],
    "cp_async_ring": [
        (SRC, "hopper::mbar_init(&full[i], 1);", "hopper::mbar_init(&full[i], 32);"),
        (SRC, "    if (lane != 0) return;\n    hopper::prefetch_map(&tk);\n    hopper::prefetch_map(&tv);\n"
              "    if (!kResident) hopper::prefetch_map(&tq);\n", ""),
        (SRC, _TMA_LOADS, _CP_ASYNC_LOADS),
    ],
    "no_v_copies": [(SRC, "hopper::mbar_expect_tx(&full[slot], (with_q ? 2 : 1) * boxes * kBox * 4);",
                     "hopper::mbar_expect_tx(&full[slot], score ? (with_q ? 2 : 1) * boxes * kBox * 4 : 0);"),
                    (SRC, "for (int b = 0; b < boxes; ++b) {", "for (int b = 0; b < (score ? boxes : 0); ++b) {")],
    "no_score_product": [(SRC, "mma3_split(f[mt][jn], ab[mt], as[mt], bb, bs);", "(void)0;")],
    "no_pv_product": [(SRC, "mma3_split(f[mt], pb[mt][kk], ps[mt][kk], bb, bs);", "(void)0;")],
}
SHAPES = ((8, 512, 4, 256, False), (8, 512, 4, 320, False), (8, 256, 2, 512, False), (8, 512, 4, 320, True))

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
    x = cs.flash_inputs("cuda", b, s, s, h, d, causal)
    fn = lambda: fk.flash_fwd(x["q"], x["k"], x["v"], causal)
    o, lse = fn()
    err = max(float((o - x["o"]).abs().max()), float((lse - x["lse"]).abs().max()))
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
    """Builds the variant's fp32 forward library; returns (root, report lines)."""
    root = unpack(name)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from flexflow_tpu_torch.ops.cuda import _build, flash_kernel as fk; fk._lib(); "
            "print(_build.build_logs.get(fk.SOURCE, ''))")
    res = subprocess.run([sys.executable, "-c", code, root], capture_output=True, text=True)
    if res.returncode:
        return root, [f"{name}: build failed", res.stderr[-3000:]]
    log = res.stdout.splitlines()
    lines = []
    for i, line in enumerate(log):
        if "Compiling entry function" in line and "flash_fwd_wide_kernel" in line:
            q = "resident Q" if "ILb1E" in line else "streamed Q"
            info = "; ".join(x.strip() for x in log[i + 1 : i + 4] if "registers" in x or "spill" in x)
            lines.append(f"{name}: flash_fwd_wide_kernel ({q}): {info}")
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
    timed = [n for n in args.variants if not any("build failed" in line for line in built[n][1])]
    for r in range(args.rounds):
        for name in (timed if r % 2 == 0 else timed[::-1]):
            subprocess.run([sys.executable, "-c", TIMER, built[name][0], name, json.dumps(SHAPES)], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
