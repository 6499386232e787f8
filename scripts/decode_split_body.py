#!/usr/bin/env python3
"""Device time and accuracy of the paged decode kernels #5 and #9 on their
two bodies, at the serving shape of chip_smoke.py (8 sequences x 16 heads
x 64, max_len 512, 16-row pages): #5 at w = 1 and 5 with kernel_inputs'
lengths (0, 512 - w and random), #5 at w = 1 with every length cut to 16
(the short contexts of chip_smoke.py's profiled decode window), and #9 at
w = 13 under a seeded draft tree. For each: the profiler's device time per
call of the split-KV body (tree_kernel.cu, what the wrappers launch at
head_dim <= 256) and of decode_kernel.cu's body (their route past it),
and the largest error of each body and of the plain PyTorch version
against a float64 evaluation of the same function on the same fp32
values (int8 rows dequantized in fp32, as all three stage them), beside
each body's error against the plain version, which chip_smoke.py gates.

    python3 scripts/decode_split_body.py [--root DIR]

--root DIR measures the flexflow_tpu_torch package under DIR (an unpacked
earlier commit or a variant, say) instead of this checkout's; the inputs
and the timers are this checkout's chip_smoke.py either way. Needs a CUDA
device; prints one JSON line."""

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="directory holding the flexflow_tpu_torch package to measure")
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
    out = {"package": os.path.dirname(dk.__file__), "device": torch.cuda.get_device_name(0)}
    cases = (("paged_flash_verify", 1, None), ("paged_flash_verify", 1, 16), ("paged_flash_verify", 5, None),
             ("paged_flash_verify_tree_quant", 13, None))
    for name, w, cut in cases:
        x = smoke.kernel_inputs(dev, w)
        if cut is not None:
            x["lengths"] = x["lengths"].clamp(max=cut)
        if name.endswith("_quant"):
            operands = (x["q"], x["k8"], x["v8"], x["k_scale"], x["v_scale"], x["tables"], x["lengths"], x["allowed"])
            kw = dict(tables=x["tables"], scales=(x["k_scale"], x["v_scale"]), allowed=x["allowed"])
            k, on_page = dk.gather_pages(x["k8"], x["tables"], x["k_scale"])
            v, _ = dk.gather_pages(x["v8"], x["tables"], x["v_scale"])
            vis = dk._tree_visible(x["allowed"], x["lengths"], w) & on_page[:, None, :]
        else:
            operands = (x["q"], x["k_pool"], x["v_pool"], x["tables"], x["lengths"])
            kw = dict(tables=x["tables"])
            k, on_page = dk.gather_pages(x["k_pool"], x["tables"])
            v, _ = dk.gather_pages(x["v_pool"], x["tables"])
            vis = dk._staircase(x["lengths"], w, k.shape[1]) & on_page[:, None, :]
        exact = dk._masked_attention(x["q"].double(), k.double(), v.double(), vis, x["q"].shape[-1] ** -0.5)
        calls = {
            "split": lambda: getattr(dk, name)(*operands),
            "decode_kernel_cu": lambda: dk._launch(name, x["q"], *operands[1:3], x["lengths"], None, **kw),
            "plain": lambda: getattr(dk, name + "_ref")(*operands),
        }
        got = {who: fn() for who, fn in calls.items()}
        torch.cuda.synchronize()
        row = {f"{who}_device_ms": smoke.device_ms(calls[who], flush) for who in ("split", "decode_kernel_cu")}
        row.update({f"{who}_vs_fp64": float((t.double() - exact).abs().max()) for who, t in got.items()})
        row.update({f"{who}_vs_plain": float((got[who] - got["plain"]).abs().max()) for who in ("split", "decode_kernel_cu")})
        out[f"{name} w={w}" + ("" if cut is None else f" lengths<={cut}")] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
