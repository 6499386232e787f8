#!/usr/bin/env python3
"""Peak rate of the TF32 tensor-core instruction that the flash backward
kernels (#2, #3, flexflow_tpu_torch/csrc/flash_bwd_kernel.cu) issue:
mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, in a loop of 8
independent accumulators per warp with operands held in registers, on
every SM of the card. It is the ceiling of any kernel built on mma.sync
(wgmma, Hopper's warpgroup instruction, has its own, higher one).

    python3 scripts/mma_tf32_rate.py

Builds a small probe library with nvcc into flexflow_tpu_torch/_build/
(the flags of ops/cuda/_build.py), then prints one JSON line: the card,
its power limit, and the dense TF32 TFLOP/s the instruction reached (2
flops per multiply-add), the best of a few runs. Needs a CUDA device."""

import ctypes
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void mma_rate_kernel(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + 1e-3f * (threadIdx.x + i)) & 0xffffe000u;
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-6f * (threadIdx.x + i)) & 0xffffe000u;
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int ff_mma_rate(void* out, int blocks, int threads, int iters, void* stream) {
  mma_rate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""

MMA_FLOPS = 2 * 16 * 8 * 8  # one m16n8k8 instruction of a warp


def build():
    from flexflow_tpu_torch.ops.cuda import _build

    tag = hashlib.sha256((SOURCE + " ".join(_build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, f"mma_rate-{tag}.cu")
    lib = os.path.join(_build.BUILD_DIR, f"libmma_rate-{tag}.so")
    if not os.path.exists(lib):
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run(_build.nvcc_command(_build.find_nvcc(), src, lib), check=True, capture_output=True)
    return ctypes.CDLL(lib)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    lib.ff_mma_rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.ff_mma_rate.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 4 * sms, 256, 20000
    out = torch.empty(blocks * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    best = 0.0
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        code = lib.ff_mma_rate(out.data_ptr(), blocks, threads, iters, stream)
        end.record()
        torch.cuda.synchronize()
        if code:
            raise RuntimeError(f"probe launch failed: cuda error {code}")
        flops = blocks * (threads // 32) * iters * 8 * MMA_FLOPS
        best = max(best, flops / (start.elapsed_time(end) / 1e3) / 1e12)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "mma_sync_m16n8k8_tf32_tflops": best, "sms": sms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
