#!/usr/bin/env python3
"""Ablations of fp32 flash #2 and #3's wide body (csrc/flash_bwd_kernel.cu,
flash_dq_wide_kernel and flash_dkv_wide_kernel, head_dim past 128): each
variant is this checkout's package with a few string edits of
csrc/flash_bwd_kernel.cu, unpacked under _checkout/variants/<name>/
(git-ignored) and built there. The script reports what ptxas says of each
variant's fp32 wide kernels (registers, spill bytes) and the TMA loads
(UTMALDG), cp.async copies (LDGSTS) and tensor-core instructions (HMMA)
of their SASS, then times #2 and #3 of every variant in fresh processes,
in turns (the variants' order, then reversed), by the profiler's device
time (chip_smoke.device_ms, three readings a process) at [8, 512, 4, 320],
[8, 512, 4, 256] and [8, 256, 2, 512] non-causal and [8, 512, 4, 320]
causal, each with its largest error against the plain version at the
timed shape. The variants:

  base                the body as it is (a producer warpgroup whose one
                      thread keeps TMA loads in flight, a ring of up to 8
                      slots, as many as shared memory leaves; setmaxnreg
                      gives a consumer thread 240 registers)
  stages_2            a ring of 2 slots
  cp_async_ring       the ring filled by the producer warp's 32 lanes with
                      cp.async (mbarrier arrivals by
                      cp.async.mbarrier.arrive) in place of TMA (producer
                      40 registers, consumers 232; LSE and delta rows as
                      lse_plain's)
  read_once           the loop tile read once: where one output chunk
                      takes all of head_dim and the ring holds a loop
                      tile's score pieces, the output products read Y0 and
                      Y1 from those slots, which are freed only then (no
                      output items)
  nine_warps          a producer warp in place of the producer warpgroup
                      and no setmaxnreg: 288 threads, so ptxas caps a
                      thread at 168 registers
  lse_plain           dK/dV's LSE and delta rows of each loop tile loaded by
                      the consumers with plain loads at the top of the tile
                      in place of the producer's flat TMA boxes beside the
                      tile's first item
  no_copies           diagnostic, wrong output: the producer loads nothing
                      (each item's full barrier completes at once)
  no_score_products   diagnostic, wrong output: the score mma's left out
                      (ptxas then drops the X and Y fragment reads too)
  no_output_products  diagnostic, wrong output: the output mma's left out
                      (and the dS, P and Y fragment reads)

    python3 scripts/flash_bwd_fp32_variants.py [--variants NAME ...] [--rounds 2]

Needs nvcc and a CUDA device; prints one JSON line per (variant,
process, shape) and the card's name and power limit."""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "flash_bwd_kernel.cu"

# the producer's TMA loads of an item, and the cp_async_ring variant's
# copies in their place: the producer warp's 32 lanes copy the boxes into
# their swizzled layout with cp.async and arrive on the full barrier when
# their copies land (dK/dV's LSE and delta rows then come as lse_plain's)
_TMA_LOADS = """        const bool with_rows = kDkv && r == 0;
        hopper::mbar_expect_tx(&full[slot], pieces * boxes * kBox * 4 + (with_rows ? 2 * kRowBox * 4 : 0));
        if (with_rows) {
          const int r0 = (int)((((int64_t)ib * p.h + ih) * p.sq + l0) & ~3ll);
          hopper::tma_load_1d(rows + (it & 1) * 128, tl, &full[slot], r0);
          hopper::tma_load_1d(rows + (it & 1) * 128 + 64, td, &full[slot], r0);
        }
        for (int b = 0; b < boxes; ++b) {
          const int cb = col + 32 * b;
          hopper::tma_load_4d(dst + b * kBox, ty0, &full[slot], cb, l0, ih, ib);
          if (score || kDkv) hopper::tma_load_4d(dst + (kPieceBoxes + b) * kBox, ty1, &full[slot], cb, l0, ih, ib);
          if (score && !kResident) {
            hopper::tma_load_4d(dst + (2 * kPieceBoxes + b) * kBox, tx0, &full[slot], cb, f0, ih, ib);
            hopper::tma_load_4d(dst + (3 * kPieceBoxes + b) * kBox, tx1, &full[slot], cb, f0, ih, ib);
          }
        }
"""
_CP_ASYNC_LOADS = """        {
          const float* qb = p.q + ib * p.q_sb + ih * p.q_sh;
          const float* gb = p.dout + ib * p.g_sb + ih * p.g_sh;
          const float* kb = p.k + ib * p.k_sb + ih * p.k_sh;
          const float* vb = p.v + ib * p.v_sb + ih * p.v_sh;
          const float* src[4] = {kDkv ? qb : kb, kDkv ? gb : vb, kDkv ? kb : qb, kDkv ? vb : gb};
          const int64_t stride[4] = {kDkv ? p.q_ss : p.k_ss, kDkv ? p.g_ss : p.v_ss, kDkv ? p.k_ss : p.q_ss,
                                     kDkv ? p.v_ss : p.g_ss};
          const int yrows = kDkv ? p.sq : p.sk;
          for (int o = 0; o < pieces; ++o) {
            const int row0 = o < 2 ? l0 : f0, rows = o < 2 ? yrows : xrows;
            for (int b = 0; b < boxes; ++b)
              for (int i = plane; i < kBox / 4; i += 32) {
                const int r = i >> 3, c = 4 * (i & 7), cg = col + 32 * b + c;
                const bool in = row0 + r < rows && cg < d;
                cp_async(dst + (o * kPieceBoxes + b) * kBox + swz(r, c),
                         in ? src[o] + (int64_t)(row0 + r) * stride[o] + cg : src[o], 16, in);
              }
          }
          asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(hopper::smem_u32(&full[slot]))
                       : "memory");
        }
"""
_PRODUCER_HEAD = """    if (threadIdx.x != 32 * kWideWarps) return;
    hopper::prefetch_map(ty0);
    hopper::prefetch_map(ty1);
    if (kDkv) {
      hopper::prefetch_map(tl);
      hopper::prefetch_map(td);
    }
    if (!kResident) {
      hopper::prefetch_map(tx0);
      hopper::prefetch_map(tx1);
    }
"""

# read_once: the score items' slots stay full until the output products
# of their loop tile have read them
_OP = "  const int op = (8 * cn + kPieceCols - 1) / kPieceCols;  // output pieces a loop tile\n"
_SCORE_ARRIVE = """      if (lane == 0) hopper::mbar_arrive(&empty[slot]);
      if (++slot == stages) slot = 0, phase ^= 1;
    }
    hopper::bar_sync(1, 32 * kWideWarps);  // every warp"""
_OUT_WAIT = """        const float* sl = ring + slot * kSlot;
        hopper::mbar_wait(&full[slot], phase);
#pragma unroll
        for (int kk = 0; kk < kR / 8; ++kk) {"""
_OUT_ARRIVE = """        if (lane == 0) hopper::mbar_arrive(&empty[slot]);
        if (++slot == stages) slot = 0, phase ^= 1;
      }
    }
  }"""

# lse_plain: the consumers load dK/dV's LSE and delta rows at the top of
# each loop tile, and the producer loads none
_ROWS_PLAIN = """    const int l0 = l_start + it * kR;
    float lt[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};  // dK/dV: of the pass columns' queries
    if constexpr (kDkv) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = l0 + 8 * pj + 2 * t + e;
        const int64_t off = ((int64_t)ib * p.h + ih) * p.sq + qi;
        lt[e] = qi < p.sq ? p.lse[off] : 0.f;
        dlt[e] = qi < p.sq ? p.delta[off] : 0.f;
      }
    }
    float s[2][4][4];"""
_LSE_PLAIN = [
    (SRC, "const bool with_rows = kDkv && r == 0;", "const bool with_rows = false;"),
    (SRC, "    const int l0 = l_start + it * kR;\n    float s[2][4][4];", _ROWS_PLAIN),
    (SRC, """      // dK/dV: LSE and delta of the pass columns' queries, in the rows that
      // came with the tile's first item (queries past sq are masked)
      const float* lb = rows + (it & 1) * 128 + (int)((((int64_t)ib * p.h + ih) * p.sq + l0) & 3) + 8 * pj + 2 * t;
""", ""),
    (SRC, "kDkv ? lb[e & 1] : lse[e >> 1], de = kDkv ? lb[64 + (e & 1)] : dl[e >> 1];",
     "kDkv ? lt[e & 1] : lse[e >> 1], de = kDkv ? dlt[e & 1] : dl[e >> 1];"),
]

# the diagnostics' edits: the score and output mma's, the fixed tile's loads
_SCORE_MMA = "for (int m = 0; m < 2; ++m) mma3_split(f[m][j], ab[m], as[m], bb, bs);"
_NO_OUTPUT_MMA = [(SRC, "mma3_split(acc[m][kPieceSteps / kOW * pc + i], ab[kk][m], as[kk][m], bb, bs);", "(void)0;")]
_X_LOAD = """        if (i < 2 * per && f0 + r < xrows)
          v[u] = __ldg(reinterpret_cast<const float4*>((o ? x1 : x0) + (int64_t)(f0 + r) * (o ? s1 : s0) + c));
"""

# name -> [(file under csrc/, text, replacement)]; "base" is the source as it is
VARIANTS = {
    "base": [],
    "stages_2": [(SRC, "constexpr int kMaxStages = 8;", "constexpr int kMaxStages = 2;")],
    "cp_async_ring": [
        (SRC, "hopper::mbar_init(&full[i], 1);", "hopper::mbar_init(&full[i], 32);"),
        (SRC, "constexpr int kProducerRegs = 24, kConsumerRegs = 240;",
              "constexpr int kProducerRegs = 40, kConsumerRegs = 232;"),
        (SRC, _PRODUCER_HEAD,
              "    if (threadIdx.x >= 32 * kWideWarps + 32) return;\n    const int plane = threadIdx.x & 31;\n"),
        (SRC, _TMA_LOADS, _CP_ASYNC_LOADS), *_LSE_PLAIN[1:],
    ],
    "read_once": [
        (SRC, _OP, _OP + "  // a loop tile's score slots are read again by its output products\n"
                         "  const bool once = kResident && gridDim.z == 1 && stages >= kp;\n"),
        (SRC, "for (int r = 0; r < kp + op; ++r) {", "for (int r = 0; r < kp + (once ? 0 : op); ++r) {"),
        (SRC, "zero<4>(s[m]);\n    for (int pc = 0; pc < kp; ++pc) {",
              "zero<4>(s[m]);\n    const int s0 = slot;\n    for (int pc = 0; pc < kp; ++pc) {"),
        (SRC, _SCORE_ARRIVE, _SCORE_ARRIVE.replace("if (lane == 0)", "if (lane == 0 && !once)")),
        (SRC, _OUT_WAIT, _OUT_WAIT.replace(
            "        const float* sl = ring + slot * kSlot;\n        hopper::mbar_wait(&full[slot], phase);",
            "        const int os = once ? (s0 + pc) % stages : slot;\n"
            "        const float* sl = ring + os * kSlot;\n"
            "        if (!once) hopper::mbar_wait(&full[slot], phase);")),
        (SRC, _OUT_ARRIVE, _OUT_ARRIVE.replace("mbar_arrive(&empty[slot])", "mbar_arrive(&empty[os])")
                                      .replace("if (++slot == stages)", "if (!once && ++slot == stages)")),
    ],
    "nine_warps": [
        (SRC, "constexpr int kWideThreads = 128 * 3;", "constexpr int kWideThreads = 32 * (kWideWarps + 1);"),
        (SRC, "    hopper::regs_dec<kProducerRegs>();\n", ""),
        (SRC, "  hopper::regs_inc<kConsumerRegs>();\n", ""),
    ],
    "lse_plain": _LSE_PLAIN,
    "no_copies": [(SRC, "const bool with_rows = kDkv && r == 0;", "const bool with_rows = false;"),
                  (SRC, "pieces * boxes * kBox * 4 + (with_rows ? 2 * kRowBox * 4 : 0));", "0);"),
                  (SRC, "        for (int b = 0; b < boxes; ++b) {\n          const int cb = col + 32 * b;",
                        "        for (int b = 0; b < 0; ++b) {\n          const int cb = col + 32 * b;")],
    "no_score_products": [(SRC, _SCORE_MMA, "(void)0;")],
    "no_products": [(SRC, _SCORE_MMA, "(void)0;"), *_NO_OUTPUT_MMA],
    "no_x_staging": [(SRC, _X_LOAD, "")],
    "no_barriers": [(SRC, f"    hopper::bar_sync(1, 32 * kWideWarps);  // {what}\n", "")
                    for what in ("every warp is done with the last tile's A fragments", "the partials are in",
                                 "dS (and P) are in")],
    "no_output_products": _NO_OUTPUT_MMA,
}
SHAPES = ((8, 512, 4, 320, False), (8, 512, 4, 256, False), (8, 256, 2, 512, False), (8, 512, 4, 320, True))

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
    args = (x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"], causal)
    dq = lambda: fk.flash_dq(*args)
    dkv = lambda: fk.flash_dkv(*args)
    got, want = (dq(), *dkv()), (fk.flash_dq_ref(*args), *fk.flash_dkv_ref(*args))
    err = max(float((a - r).abs().max()) for a, r in zip(got, want))
    t_dq = [cs.device_ms(dq, flush) for _ in range(3)]
    t_dkv = [cs.device_ms(dkv, flush) for _ in range(3)]
    pair = [None if None in (a, c) else a + c for a, c in zip(t_dq, t_dkv)]
    print(json.dumps({"variant": sys.argv[2], "shape": [b, s, h, d], "causal": causal, "max_abs_err": err,
                      "dq_ms": t_dq, "dkv_ms": t_dkv, "pair_ms": pair}), flush=True)
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
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} found {text.count(old)} times in csrc/{f}")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    return root


def sass_counts(root):
    """{fp32 wide kernel: {UTMALDG, LDGSTS, HMMA counts, all its
    instructions}} of the variant's backward library (chip_smoke.sass_opcodes
    of the variant's checkout)."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "from flexflow_tpu_torch.ops.cuda import flash_kernel as fk; "
            "ops = chip_smoke.sass_opcodes(fk.BWD_SOURCE, r'flash_(dq|dkv)_wide_kernelILb[01]E'); "
            "print(json.dumps({f: dict({op: c.get(op, 0) for op in ('UTMALDG', 'LDGSTS', 'HMMA')}, "
            "all=sum(c.values())) for f, c in ops.items()}))")
    out = subprocess.run([sys.executable, "-c", code, root], capture_output=True, text=True, check=True).stdout
    counts = json.loads(out)
    return {re.search(r"flash_(?:dq|dkv)_wide_kernelILb[01]E", f).group(0): c for f, c in counts.items()}


def build(name):
    """Builds the variant's backward library; returns (root, report lines)."""
    root = unpack(name)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from flexflow_tpu_torch.ops.cuda import _build, flash_kernel as fk; fk._bwd_lib(); "
            "print(_build.build_logs.get(fk.BWD_SOURCE, ''))")
    res = subprocess.run([sys.executable, "-c", code, root], capture_output=True, text=True)
    if res.returncode:
        return root, [f"{name}: build failed", res.stderr[-3000:]]
    log = res.stdout.splitlines()
    lines = []
    for i, line in enumerate(log):
        m = re.search(r"(flash_(?:dq|dkv)_wide_kernel)ILb([01])E", line)
        if "Compiling entry function" in line and m:
            x = "resident X" if m.group(2) == "1" else "streamed X"
            info = "; ".join(x.strip() for x in log[i + 1 : i + 4] if "registers" in x or "spill" in x)
            lines.append(f"{name}: {m.group(1)} ({x}): {info}")
    lines += [f"{name}: ptxas {line.strip()[:200]}" for line in log if "serialized" in line]
    lines.append(f"{name}: SASS " + json.dumps(sass_counts(root)))
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
