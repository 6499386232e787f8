#!/usr/bin/env python3
"""Device time and accuracy of the staircase decode kernels #4, #5 and #6
and the int8 tree verify #9 on their two bodies, at the serving shape of
chip_smoke.py (8 sequences x 16 heads x 64, max_len 512, 16-row pages):
#4 (contiguous cache) and #5 (fp32 pools) and #6 (int8 pools) at w = 1
and 5 with kernel_inputs' lengths (0, 512 - w and random), each also at
w = 1 with every length cut to 16 (the short contexts of chip_smoke.py's
profiled decode windows), and #9 at w = 13 under a seeded draft tree. For
each: the profiler's device time per call of the split-KV body
(tree_kernel.cu, what the wrappers launch at head_dim <= 256) and of
decode_kernel.cu's body (their route past it), and the largest error of
each body and of the plain PyTorch version against a float64 evaluation
of the same function on the same fp32 values (int8 rows dequantized in
fp32, as all three stage them), beside each body's error against the
plain version, which chip_smoke.py gates.

    python3 scripts/decode_split_body.py [--root DIR] [--quant-spans N ...] [--head-dim D]

--root DIR measures the flexflow_tpu_torch package under DIR (an unpacked
earlier commit or a variant, say) instead of this checkout's; the inputs
and the timers are this checkout's chip_smoke.py either way.
--quant-spans also times #6's w = 1 cases with each given span unit (a
multiple of 64 positions: the split rule's step, decode_kernel.py's
_QUANT_SPAN_UNIT) in place of the package's own. --head-dim D takes every
case at head_dim D (default 64); past 256 the wrapper ("split") routes
to decode_kernel.cu's body too. Needs a CUDA device; prints one JSON
line."""

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (kernel, w, lengths cut to) at the serving shape
CASES = (
    ("flash_verify", 1, None), ("flash_verify", 1, 16), ("flash_verify", 5, None),
    ("paged_flash_verify", 1, None), ("paged_flash_verify", 1, 16), ("paged_flash_verify", 5, None),
    ("paged_flash_verify_quant", 1, None), ("paged_flash_verify_quant", 1, 16),
    ("paged_flash_verify_quant", 5, None),
    ("paged_flash_verify_tree_quant", 13, None),
)


def operands(dk, name, x, w):
    """(the wrapper's operands, the body launchers' keywords, the dense
    [b, L, h, d] K and V in fp32 and the [b, w, L] visible pairs)."""
    paged, quant, tree = name.startswith("paged"), "quant" in name, "tree" in name
    if not paged:
        ops = (x["q"], x["k_cache"], x["v_cache"], x["lengths"])
        k, v = x["k_cache"], x["v_cache"]
        vis = dk._staircase(x["lengths"], w, k.shape[1])
        return ops, {}, k, v, vis
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
    for name, w, cut in CASES:
        x = smoke.kernel_inputs(dev, w, d=args.head_dim)
        if cut is not None:
            x["lengths"] = x["lengths"].clamp(max=cut)
        ops, kw, k, v, vis = operands(dk, name, x, w)
        exact = dk._masked_attention(x["q"].double(), k.double(), v.double(), vis, x["q"].shape[-1] ** -0.5)
        spans = [None]
        if name == "paged_flash_verify_quant" and w == 1 and own_span is not None:
            spans += [s for s in args.quant_spans if s != own_span]
        for span in spans:
            if span is not None:
                dk._QUANT_SPAN_UNIT = span
            calls = {
                "split": lambda: getattr(dk, name)(*ops),
                "decode_kernel_cu": lambda: dk._launch(name, x["q"], ops[1], ops[2], x["lengths"], None, **kw),
                "plain": lambda: getattr(dk, name + "_ref")(*ops),
            }
            got = {who: fn() for who, fn in calls.items()}
            torch.cuda.synchronize()
            row = {f"{who}_device_ms": smoke.device_ms(calls[who], flush) for who in ("split", "decode_kernel_cu")}
            row.update({f"{who}_vs_fp64": float((t.double() - exact).abs().max()) for who, t in got.items()})
            row.update({f"{who}_vs_plain": float((got[who] - got["plain"]).abs().max())
                        for who in ("split", "decode_kernel_cu")})
            key = f"{name} w={w}" + ("" if cut is None else f" lengths<={cut}") + ("" if span is None else f" span={span}")
            out[key] = row
        if own_span is not None:
            dk._QUANT_SPAN_UNIT = own_span
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
