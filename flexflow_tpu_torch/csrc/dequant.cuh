// int8 KV rows to fp32, shared by the decode bodies (decode_kernel.cu, #6
// and #9 past head_dim 256; tree_kernel.cu, #9): each element times its
// (page, head) scale in one fp32 multiply, as the reference dequantizes
// (attention._dequant_pages), so staged rows are bit-identical to the
// plain version's dense dequant.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// 16 int8 values times their page's scale, as four float4 in shared memory
__device__ __forceinline__ void store_dequant(float* dst, int4 raw, float s) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int u = 0; u < 4; ++u)
    d4[u] = make_float4((float)b[4 * u] * s, (float)b[4 * u + 1] * s,
                        (float)b[4 * u + 2] * s, (float)b[4 * u + 3] * s);
}
