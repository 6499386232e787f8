#!/usr/bin/env python3
"""Ablations of fp32 flash #2 and #3 up to head_dim 128 (csrc/flash_bwd_kernel.cu,
flash_dq_tf32_kernel and flash_dkv_tf32_kernel): each variant is this
checkout's package with a few string edits of csrc/flash_bwd_kernel.cu,
unpacked under _checkout/variants/<name>/ (git-ignored) and built there.
The script reports what ptxas says of each variant's tf32 kernels
(registers, spill bytes, wgmma serialization advisories) and the
tensor-core instructions of their SASS (HGMMA: wgmma; HMMA: mma.sync),
then times #2 and #3 of every variant in fresh processes, in turns (the
variants' order, then reversed), by the profiler's device time
(chip_smoke.device_ms, three readings a process) at [8, 512, 16, 64]
causal and not, [8, 512, 8, 128] and [8, 512, 32, 32], each with its
largest error against the plain version. `--parent DIR` also times
another checkout (unpacked under _checkout/, e.g. the commit before the
tf32 bodies, whose 3xTF32 mma.sync body splits every operand per
fragment read) in the same turns, as the variant "parent". The variants
(Tf32Cfg<32-column boxes, consumer warpgroups, ring slots> names a
kernel's block at a bucket; DqB1 and DkvB1 are head_dim 33-64's):

  base                the body as it is
  dkv_b1_wg2_s1       dK/dV at head_dim 33-64: two consumer warpgroups and
                      1 ring slot in place of one and 2
  one_chain           the three passes of a score product into one chain
                      (the small terms not apart)
  no_copies           diagnostic, wrong output: the producer loads nothing
  no_split            diagnostic, wrong output: no small copies or transposes
  no_score_products   diagnostic, wrong output: no score wgmma
  no_output_products  diagnostic, wrong output: no output wgmma (ptxas then
                      drops the score wgmma too: their results go unused)

    python3 scripts/flash_bwd_tf32_variants.py [--variants NAME ...] [--rounds 2] [--parent _checkout/parent]

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

_DKV1 = "using DkvB1 = Tf32Cfg<2, 1, 2>;"
_SMALL_PASSES = """      hopper::WgmmaTf32SS<kN>::run(small, hopper::desc_kmajor_tf32(xb + x_far, kk), hopper::desc_kmajor_tf32(yb, kk),
                                   keep);
      hopper::WgmmaTf32SS<kN>::run(small, hopper::desc_kmajor_tf32(xb, kk), hopper::desc_kmajor_tf32(yb + y_far, kk),
                                   1);
"""
_BIG_PASS = """      hopper::WgmmaTf32SS<kN>::run(big, hopper::desc_kmajor_tf32(xb, kk), hopper::desc_kmajor_tf32(yb, kk), keep);
"""
_OUT = """      issue_tf32_out<kB * 32>(acc0, db, ds, sl + 4 * kOp, sl + 5 * kOp);
      if constexpr (kDkv) issue_tf32_out<kB * 32>(acc1, pfb, pfs, sl + 6 * kOp, sl + 7 * kOp);
"""

# name -> [(file under csrc/, text, replacement)]; "base" is the source as it is
VARIANTS = {
    "base": [],
    "dkv_b1_wg2_s1": [(SRC, _DKV1, "using DkvB1 = Tf32Cfg<2, 2, 1>;")],
    "one_chain": [(SRC, _SMALL_PASSES + _BIG_PASS,
                   (_SMALL_PASSES + _BIG_PASS).replace("run(small,", "run(big,").replace("kk), keep);", "kk), 1);")),
                  (SRC, "        s[i] = sb[i] + ss[i];\n        dp[i] = pb[i] + ps[i];\n",
                        "        s[i] = sb[i];\n        dp[i] = pb[i];\n")],
    "no_copies": [(SRC, "hopper::mbar_expect_tx(full_x, 2 * kB * C::kXBox * 4);", "hopper::mbar_arrive(full_x);"),
                  (SRC, "        hopper::mbar_expect_tx(&full[slot], 2 * kB * C::kYBox * 4 + (kDkv ? 2 * C::kRowBox * 4 : 0));\n"
                        "        for (int bx = 0; bx < kB; ++bx) {",
                        "        hopper::mbar_arrive(&full[slot]);\n        for (int bx = 0; bx < 0; ++bx) {"),
                  (SRC, "      for (int bx = 0; bx < kB; ++bx) {\n        hopper::tma_load_4d(fixed + bx * C::kXBox",
                        "      for (int bx = 0; bx < 0; ++bx) {\n        hopper::tma_load_4d(fixed + bx * C::kXBox"),
                  (SRC, "        if constexpr (kDkv) {\n          const int r0 = (int)(",
                        "        if constexpr (false) {\n          const int r0 = (int)(")],
    "no_split": [(SRC, "  for (int i = i0; i < n4; i += step) {", "  for (int i = i0; i < 0; i += step) {"),
                 (SRC, "  for (int q = w; q < 8 * kB; q += nw) {", "  for (int q = w; q < 0; q += nw) {")],
    "no_score_products": [(SRC, _SMALL_PASSES + _BIG_PASS, "")],
    "no_output_products": [(SRC, _OUT, "")],
}
SHAPES = ((8, 512, 16, 64, False), (8, 512, 16, 64, True), (8, 512, 8, 128, False), (8, 512, 32, 32, False))

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
    """{tf32 kernel (kind, block): {HGMMA, HMMA, UTMALDG counts, all its
    instructions}} of the variant's backward library."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "from flexflow_tpu_torch.ops.cuda import flash_kernel as fk; "
            "ops = chip_smoke.sass_opcodes(fk.BWD_SOURCE, r'flash_(dq|dkv)_tf32_kernel'); "
            "print(json.dumps({f: dict({op: c.get(op, 0) for op in ('HGMMA', 'HMMA', 'UTMALDG')}, "
            "all=sum(c.values())) for f, c in ops.items()}))")
    out = subprocess.run([sys.executable, "-c", code, root], capture_output=True, text=True, check=True).stdout
    return {_short(f): c for f, c in json.loads(out).items()}


def _short(mangled):
    """flash_dq_tf32_kernel<2, 2, 2> of a mangled name."""
    m = re.search(r"(flash_(?:dq|dkv)_tf32_kernel)INS_7Tf32CfgILi(\d+)ELi(\d+)ELi(\d+)E", mangled)
    return f"{m.group(1)}<{', '.join(m.group(i) for i in range(2, 5))}>" if m else mangled[:80]


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
        if "Compiling entry function" in line and "tf32_kernel" in line:
            info = "; ".join(x.strip() for x in log[i + 1 : i + 4] if "registers" in x or "spill" in x)
            lines.append(f"{name}: {_short(line)}: {info}")
    lines += [f"{name}: ptxas {line.strip()[:200]}" for line in log if "serialized" in line]
    lines.append(f"{name}: SASS " + json.dumps(sass_counts(root)))
    return root, lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2, help="timed processes of each variant")
    ap.add_argument("--parent", default=None, help="another checkout timed in the same turns")
    args = ap.parse_args()
    with ThreadPoolExecutor(min(8, len(args.variants))) as pool:
        built = dict(zip(args.variants, pool.map(build, args.variants)))
    for name in args.variants:
        print("\n".join(built[name][1]), flush=True)
    roots = {n: built[n][0] for n in args.variants if not any("build failed" in line for line in built[n][1])}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    order = list(roots)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            subprocess.run([sys.executable, "-c", TIMER, roots[name], name, json.dumps(SHAPES)], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
