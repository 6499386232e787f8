// Element conversions shared by the decode bodies (decode_kernel.cu past
// head_dim 256; tree_kernel.cu up to it):
//   * int8 KV rows to fp32: each element times its (page, head) scale in
//     one fp32 multiply, as the reference dequantizes
//     (attention._dequant_pages), so staged rows are bit-identical to the
//     plain version's dense dequant; a row is read in 16-byte loads where
//     it is 16-byte aligned and in 8-byte loads elsewhere;
//   * q and the output in q's element type, float or __nv_bfloat16 (a
//     mixed-precision model's projections hand the kernels bf16 q against
//     fp32 or int8 pools): 4 elements at a time, bf16 widened to fp32 as
//     it is read (exact) and the fp32 output rounded to nearest even as
//     it is written, the reference's `.astype(o_ref.dtype)`.
#pragma once

#include <cuda_bf16.h>
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

// 8 int8 values (one 8-byte load) times their page's scale, as two float4
__device__ __forceinline__ void store_dequant8(float* dst, int2 raw, float s) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int u = 0; u < 2; ++u)
    d4[u] = make_float4((float)b[4 * u] * s, (float)b[4 * u + 1] * s,
                        (float)b[4 * u + 2] * s, (float)b[4 * u + 3] * s);
}

// 4 consecutive elements of q as fp32: one 16-byte load of float, one
// 8-byte load of bf16 (so a bf16 row needs 8-byte alignment)
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);

template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// 4 consecutive output elements from fp32, rounded to nearest even for bf16
template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v);

template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 r;
  r.x = *reinterpret_cast<const uint32_t*>(&a);
  r.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = r;
}

// one output element from fp32
template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
