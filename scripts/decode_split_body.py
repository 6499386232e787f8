#!/usr/bin/env python3
"""Device time and accuracy of the decode kernels #4-#9 on their bodies, at
the serving shape of chip_smoke.py (8 sequences x 16 heads x 64, max_len
512, 16-row pages): #4 (contiguous cache), #5 (fp32 pools) and #6 (int8
pools) at w = 1 and 5 with kernel_inputs' lengths (0, 512 - w and
random), each also at w = 1 with every length cut to 16 (the short
contexts of chip_smoke.py's profiled decode windows), #5 at w = 1 also
with the flagship burst's lengths (burst_lengths), #7, #8 and #9 at w =
13 under a seeded draft tree, and #5 at w = 1 and #9 at w = 13 at bf16 q
too. For each: the profiler's device time per call of the body the
wrapper takes ("wrapper": the split-KV body of tree_kernel.cu at head_dim
<= 256) and of decode_kernel.cu's body (the route past head_dim 256), and
the largest error of each and of the plain PyTorch version against a
float64 evaluation of the same function on the same fp32 values (int8
rows dequantized in fp32, as all of them stage them), beside each body's
error against the plain version, which chip_smoke.py gates.

    python3 scripts/decode_split_body.py [--root DIR] [--cases TEXT ...] [--readings N]
        [--bodies NAME ...] [--quant-spans N ...] [--head-dim D] [--serving]

--root DIR measures the flexflow_tpu_torch package under DIR (an unpacked
earlier commit or a variant, say) instead of this checkout's; the inputs,
the timers and the profiler's kernel names are this checkout's
chip_smoke.py either way. --cases keeps the cases whose label holds one of
the texts; --readings takes that many profiler readings a case (default
1); --bodies times only the named ones of wrapper and decode_kernel_cu
(each builds its library at first use). --quant-spans also times #6's w =
1 cases with each given span unit (a multiple of 64 positions: the split
rule's step, decode_kernel.py's _QUANT_SPAN_UNIT) in place of the
package's own. --head-dim D takes every case at head_dim D (default 64);
past 256 the wrapper routes to decode_kernel.cu's body too. --serving then
serves the full-width flagship LM of chip_smoke.py (12 layers, seeded
weights) and gives #5's device time per call on its traffic, from the
profiler (serving_profile). Needs a CUDA device; prints one JSON line
last.
"""

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (kernel, w, lengths cut to or "burst" (burst_lengths), q dtype) at the serving shape
CASES = (
    ("flash_verify", 1, None, "float32"), ("flash_verify", 1, 16, "float32"), ("flash_verify", 5, None, "float32"),
    ("paged_flash_verify", 1, None, "float32"), ("paged_flash_verify", 1, 16, "float32"),
    ("paged_flash_verify", 1, "burst", "float32"), ("paged_flash_verify", 5, None, "float32"),
    ("paged_flash_verify", 1, None, "bfloat16"), ("paged_flash_verify", 1, 16, "bfloat16"),
    ("paged_flash_verify", 1, "burst", "bfloat16"),
    ("paged_flash_verify_quant", 1, None, "float32"), ("paged_flash_verify_quant", 1, 16, "float32"),
    ("paged_flash_verify_quant", 5, None, "float32"),
    ("flash_verify_tree", 13, None, "float32"), ("paged_flash_verify_tree", 13, None, "float32"),
    ("paged_flash_verify_tree_quant", 13, None, "float32"), ("paged_flash_verify_tree_quant", 13, None, "bfloat16"),
)


def burst_lengths(b, seed):
    """The lengths of b sequences of chip_smoke.py's flagship burst
    (mixed_requests: prompts of 1 + i % 6 tokens, then 32 new tokens for
    even i and 248 for odd i), each at a seeded uniform point of its
    request's decode: the contexts one decode step of the burst sees."""
    import numpy as np

    rng = np.random.default_rng(seed)
    new = [32 if i % 2 == 0 else 248 for i in range(b)]
    return [1 + i % 6 + int(rng.integers(0, new[i])) for i in range(b)]


def serving_profile(smoke):
    """#5's device time per call on the flagship LM's traffic (12 layers
    at full width, seeded weights): the burst of chip_smoke.py's
    multistep_burst (NUM_REQUESTS mixed requests in graph windows) under
    the profiler, then chip_smoke.py's profile_decode window at contexts
    of 3-19 and of 243-259 tokens and profile_multistep's 4c graph
    windows; each as step_breakdown gives it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.serving import Request

    geo = smoke.FLAGSHIP
    model = smoke.build_lm("cuda", **geo)
    smoke.serve(model, [Request(rid=i, prompt=[1 + i], max_new_tokens=8) for i in range(4)])  # warm-up
    kernel = "paged_flash_verify"
    reqs = smoke.mixed_requests(geo["vocab"], geo["max_len"], smoke.NUM_REQUESTS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, stats, launches, _ = smoke.serve(model, reqs, decode_multistep=True, max_fused_steps=smoke.MULTISTEP_STEPS)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    out = {"burst": smoke.step_breakdown("burst, graph windows", events, stats.decode_steps, kernel, launches[kernel])}
    out["decode 3-19"] = smoke.profile_decode(model, kernel=kernel)["kernel"]
    out["decode 243-259"] = smoke.profile_decode(model, kernel=kernel, skip=smoke.LONG_WINDOW_SKIP,
                                                 label="decode, long contexts")["kernel"]
    out["4c windows"] = smoke.profile_multistep(model, "4c windows", 4, kernel=kernel, decode_multistep=True,
                                                max_fused_steps=smoke.MULTISTEP_STEPS)["kernel"]
    return out


def operands(dk, name, x, w):
    """(the wrapper's operands, the body launchers' keywords, the dense
    [b, L, h, d] K and V in fp32 and the [b, w, L] visible pairs)."""
    paged, quant, tree = name.startswith("paged"), "quant" in name, "tree" in name
    if not paged:
        k, v = x["k_cache"], x["v_cache"]
        if tree:
            return ((x["q"], k, v, x["lengths"], x["allowed"]), dict(allowed=x["allowed"]), k, v,
                    dk._tree_visible(x["allowed"], x["lengths"], w))
        return (x["q"], k, v, x["lengths"]), {}, k, v, dk._staircase(x["lengths"], w, k.shape[1])
    pools = (x["k8"], x["v8"]) if quant else (x["k_pool"], x["v_pool"])
    scales = (x["k_scale"], x["v_scale"]) if quant else (None, None)
    k, on_page = dk.gather_pages(pools[0], x["tables"], scales[0])
    v, _ = dk.gather_pages(pools[1], x["tables"], scales[1])
    vis = dk._tree_visible(x["allowed"], x["lengths"], w) if tree else dk._staircase(x["lengths"], w, k.shape[1])
    vis = vis & on_page[:, None, :]
    ops = (x["q"], *pools) + (scales if quant else ()) + (x["tables"], x["lengths"]) + ((x["allowed"],) if tree else ())
    kw = dict(tables=x["tables"])
    if quant:
        kw["scales"] = scales
    if tree:
        kw["allowed"] = x["allowed"]
    return ops, kw, k, v, vis


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="directory holding the flexflow_tpu_torch package to measure")
    ap.add_argument("--cases", nargs="*", default=[], help="keep the cases whose label holds one of these")
    ap.add_argument("--readings", type=int, default=1, help="profiler readings a case and body")
    ap.add_argument("--serving", action="store_true", help="then #5's device time per call on the flagship's traffic")
    ap.add_argument("--bodies", nargs="*", default=["wrapper", "decode_kernel_cu"],
                    help="the bodies to time (each builds its library at first use)")
    ap.add_argument("--quant-spans", type=int, nargs="*", default=[],
                    help="also time #6 at w = 1 with each of these span units")
    ap.add_argument("--head-dim", type=int, default=64, help="head_dim of every case")
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
    dev = torch.device("cuda")
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    flush = lambda: flush_buf.zero_()
    own_span = getattr(dk, "_QUANT_SPAN_UNIT", None)
    out = {"package": os.path.dirname(dk.__file__), "device": torch.cuda.get_device_name(0),
           "quant_span_unit": own_span, "head_dim": args.head_dim}
    smoke.warm_card()
    for name, w, cut, qd in CASES:
        key = f"{name} w={w}" + {None: "", "burst": " burst lengths"}.get(cut, f" lengths<={cut}") + \
            ("" if qd == "float32" else f" {qd} q")
        if args.cases and not any(c in key for c in args.cases):
            continue
        lengths = {"lengths": burst_lengths(8, smoke.SEED)} if cut == "burst" else {}
        x = smoke.kernel_inputs(dev, w, d=args.head_dim, **lengths)
        if isinstance(cut, int):
            x["lengths"] = x["lengths"].clamp(max=cut)
        x["q"] = x["q"].to(getattr(torch, qd))
        ops, kw, k, v, vis = operands(dk, name, x, w)
        exact = dk._masked_attention(x["q"].double(), k.double(), v.double(), vis, x["q"].shape[-1] ** -0.5)
        spans = [None]
        if name == "paged_flash_verify_quant" and w == 1 and own_span is not None:
            spans += [s for s in args.quant_spans if s != own_span]
        for span in spans:
            if span is not None:
                dk._QUANT_SPAN_UNIT = span
            calls = {
                "wrapper": lambda: getattr(dk, name)(*ops),
                "decode_kernel_cu": lambda: dk._launch(name, x["q"], ops[1], ops[2], x["lengths"], None, **kw),
                "plain": lambda: getattr(dk, name + "_ref")(*ops),
            }
            calls = {who: fn for who, fn in calls.items() if who in args.bodies or who == "plain"}
            got = {who: fn() for who, fn in calls.items()}
            torch.cuda.synchronize()
            bodies = [who for who in calls if who != "plain"]
            row = {f"{who}_device_ms": [smoke.device_ms(calls[who], flush) for _ in range(args.readings)]
                   for who in bodies}
            row.update({f"{who}_vs_fp64": float((t.double() - exact).abs().max()) for who, t in got.items()})
            row.update({f"{who}_vs_plain": float((got[who].float() - got["plain"].float()).abs().max())
                        for who in bodies})
            out[key + ("" if span is None else f" span={span}")] = row
        if own_span is not None:
            dk._QUANT_SPAN_UNIT = own_span
    if args.serving:
        out["serving"] = serving_profile(smoke)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
