#!/usr/bin/env python3
"""Phase 3's serving burst of chip_smoke.py, timed on several trees in turns.

Each reading is a fresh process that runs, from the root of one tree (a
checkout of this repo), that tree's own `chip_smoke.serve_flagship("cuda")`:
the full-width flagship decoder LM (12 layers, hidden 1024, 16 heads,
vocab 32000, 8 slots x 512 tokens, random weights from the seed) serving
32 mixed requests greedily, one eager decode step an iteration. Then the
same model serves the same requests at temperature 0.8, seed 1234, where
the tree's ServeConfig takes a temperature and a seed (null where not).

The trees run in turns, first to last and back (A B C C B A), `--turns`
times. The kernel libraries are built once, in the first tree, and copied
into the others (a library's name carries a hash of its sources, so a
tree whose sources differ builds its own). Run from the root of a
checkout on a CUDA machine:

    python3 scripts/serve_burst_ab.py --tree parent=DIR --tree this=. [--turns 2]

It prints the card's name and power limit, then one JSON line a reading:
tokens/s, decode steps and mean ms a decode step, greedy and sampled.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys

CHILD = r"""
import json
import chip_smoke as cs

model, greedy, _, _ = cs.serve_flagship("cuda")
out = {"greedy": {k: greedy[k] for k in ("tokens", "tokens_per_s", "decode_steps", "mean_decode_step_ms")}}
try:
    done, stats, _, _ = cs.serve(
        model, cs.mixed_requests(cs.FLAGSHIP["vocab"], cs.FLAGSHIP["max_len"], cs.NUM_REQUESTS),
        temperature=0.8, seed=1234,
    )
except (NotImplementedError, TypeError):  # no temperature, or no seed field
    out["sampled"] = None
else:
    cs.require(all(r.status == "finished" for r in done), "sampled burst: a request did not finish")
    out["sampled"] = dict(tokens=stats.tokens_generated, tokens_per_s=stats.tokens_per_s,
                          decode_steps=stats.decode_steps, mean_decode_step_ms=1e3 * stats.mean_decode_step_s)
print("READING " + json.dumps(out))
"""

BUILD = "import chip_smoke as cs; cs.build_kernels()"


def run(tree: str, code: str) -> str:
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env, capture_output=True, text=True)
    if proc.returncode:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
        raise SystemExit(f"{tree}: exit {proc.returncode}")
    return proc.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, help="NAME=DIR, a checkout of this repo")
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args()
    trees = [(name, os.path.abspath(d)) for name, d in (t.split("=", 1) for t in args.tree)]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    first = trees[0][1]
    run(first, BUILD)
    for _, tree in trees[1:]:
        dest = os.path.join(tree, "flexflow_tpu_torch", "_build")
        os.makedirs(dest, exist_ok=True)
        for lib in glob.glob(os.path.join(first, "flexflow_tpu_torch", "_build", "*.so")):
            if not os.path.exists(os.path.join(dest, os.path.basename(lib))):
                shutil.copy2(lib, dest)
        run(tree, BUILD)  # builds only what the copies do not cover

    order = trees + trees[::-1]
    for turn in range(args.turns):
        for name, tree in order:
            line = next(ln for ln in run(tree, CHILD).splitlines() if ln.startswith("READING "))
            reading = json.loads(line[len("READING "):])
            print(json.dumps(dict(tree=name, turn=turn, **reading)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
