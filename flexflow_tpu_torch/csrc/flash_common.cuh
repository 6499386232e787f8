// Shared parts of the flash attention kernels for Hopper (sm_90a): the
// forward #1 (csrc/flash_kernel.cu) and the backward #2, #3
// (csrc/flash_bwd_kernel.cu) include this header. It holds the block
// layout, the launch parameters, fp32-accurate 3xTF32 products on the
// tensor cores (mma.sync m16n8k8), the cp.async staging of [b, s, h, d]
// rows and the output stores. The reasoning behind the 3xTF32 products is
// in flash_bwd_kernel.cu's header. ops/cuda/_build.py hashes this file into
// the name of every library whose source includes it.
//
// The backward's bf16 wide kernels (head_dim past kStagedMaxD; mixed
// precision, element type T = __nv_bfloat16) widen each bf16 row to fp32
// as they stage it (load_tile_bf16), the products take one TF32
// pass (a bf16 value, 8 significant bits, is a TF32 value, so its split has
// no small part and the pass is exact; kOne below), and the outputs are
// rounded to bf16 as they are stored (store_rows).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;     // rows of the fixed operand's tile
constexpr int kLoop = 32;     // rows of the loop operand's tile
constexpr int kWarps = 4;     // 16 rows of the fixed tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = kLoop / 8;  // 8-wide n-tiles of one loop tile's scores
// head_dims up to this take bf16 #1-#3's wgmma bodies (flash_bf16_kernel.cu);
// past it bf16 runs the wide kernels
constexpr int kStagedMaxD = 256;
// n-tiles of one streamed piece of head_dim in the backward's wide
// kernels, staged at the stride of bucket 2 (ld_of<16>(), 132 floats)
constexpr int kPieceTiles = 16;
constexpr int kFrag = 32 * 4;  // floats of one warp's m16n8 fragment

// Row stride of a staged tile for head_dims of the kDT bucket.
template <int kDT>
__host__ __device__ constexpr int ld_of() { return 8 * kDT + 4; }

// head_dim bucket of the mma kernels up to 128: 8-column tiles kDT = 4,
// 8 or 16 staged at full width (0-2); past 128 both directions run their
// wide kernels, which the callers test first
inline int bucket(int d) { return d <= 32 ? 0 : d <= 64 ? 1 : 2; }

// any head_dim that is a multiple of 8, as the reference's supports()
inline bool takes(int d) { return d > 0 && d % 8 == 0; }

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;   // dO [b, sq, h, d] (backward)
  const float* lse;    // [b, h, sq] (backward)
  const float* delta;  // [b, h, sq], rowsum(dO * O) - g_lse (backward)
  float* out0;         // O, dQ or dK (contiguous [b, s, h, d])
  float* out1;         // LSE [b, h, sq] (forward) or dV
  int h, sq, sk, d;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t g_sb, g_ss, g_sh;
  float scale;
  int causal;
};

// Offset of element (r, c) in a TMA box of 32 fp32 columns (128 bytes a
// row): row r at 128 r bytes, its 16-byte chunk c / 4 at chunk
// c / 4 ^ r % 8 (TMA's 128-byte swizzle). The fp32 wide bodies of #1-#3
// read their ring's boxes through it.
__device__ __forceinline__ int swz(int r, int c) { return r * 32 + (((c >> 2) ^ (r & 7)) << 2) + (c & 3); }

// This block's output columns: n-tiles [c0t, c0t + cn) of the head_dim's
// dt, cut evenly over the grid's z.
__device__ __forceinline__ void z_chunk(int dt, int& c0t, int& cn) {
  const int ct = (dt + gridDim.z - 1) / gridDim.z;
  c0t = blockIdx.z * ct;
  cn = min(ct, dt - c0t);
}

// -- 3xTF32 on the tensor cores ---------------------------------------------------

// x = big + small as two TF32 operands. big: x with its 13 low mantissa
// bits cleared (TF32 toward zero); small: the exact rest with half a TF32
// ulp added to its magnitude, which the tensor core, ignoring the 13 low
// bits of a .tf32 operand, reads as tf32_rna(x - big).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small terms first; a and b already split (a is
// reused across a k-step's n-tiles, b across m-tiles). kOne: a and b are
// TF32 values (widened bf16: big is the value, small is 0), and the one
// big pass is the exact product.
template <bool kOne = false>
__device__ __forceinline__ void mma3_split(float c[4], const uint32_t ab[4], const uint32_t as[4],
                                           const uint32_t bb[2], const uint32_t bs[2]) {
  if constexpr (!kOne) {
    mma_tf32(c, as, bb);
    mma_tf32(c, ab, bs);
  }
  mma_tf32(c, ab, bb);
}

// mma3_split with b split here (b feeds one accumulator).
template <bool kOne = false>
__device__ __forceinline__ void mma3(float c[4], const uint32_t ab[4],
                                     const uint32_t as[4], const float b[2]) {
  uint32_t bb[2], bs[2];
  split(b[0], bb[0], bs[0]);
  split(b[1], bb[1], bs[1]);
  mma3_split<kOne>(c, ab, as, bb, bs);
}

// An accumulator fragment's values v (rows g, g + 8 at columns 2t, 2t + 1)
// as the split A fragment of the next product, whose k index runs over
// those columns in the order product_pn reads them: {v0, v2, v1, v3}.
// The wide kernels hand P and dS from the warps that compute them to the
// warps of the output products through shared memory in this form.
template <bool kOne>
__device__ __forceinline__ void put_a(float* big, float* small, const float v[4]) {
  uint32_t b[4], s[4];
  split(v[0], b[0], s[0]);
  split(v[2], b[1], s[1]);
  split(v[1], b[2], s[2]);
  split(v[3], b[3], s[3]);
  *reinterpret_cast<uint4*>(big) = make_uint4(b[0], b[1], b[2], b[3]);
  if constexpr (!kOne) *reinterpret_cast<uint4*>(small) = make_uint4(s[0], s[1], s[2], s[3]);
}

template <bool kOne>
__device__ __forceinline__ void get_a(const float* big, const float* small, uint32_t ab[4], uint32_t as[4]) {
  const uint4 b = *reinterpret_cast<const uint4*>(big);
  ab[0] = b.x, ab[1] = b.y, ab[2] = b.z, ab[3] = b.w;
  if constexpr (!kOne) {
    const uint4 s = *reinterpret_cast<const uint4*>(small);
    as[0] = s.x, as[1] = s.y, as[2] = s.z, as[3] = s.w;
  } else {
    as[0] = as[1] = as[2] = as[3] = 0u;
  }
}

// -- products of one warp -------------------------------------------------------
// Lane l is (g, t) = (l / 4, l % 4). An m16n8 accumulator c[4] holds rows g
// (c[0], c[1]) and g + 8 (c[2], c[3]) at columns 2t and 2t + 1.

// acc0[j] += A0 B0_j^T and acc1[j] += A1 B1_j^T, the two products taken
// together so that 2 kNT accumulators are in flight: A0, A1 are 16 rows and
// B0, B1 8 kNT rows, all row-major with head_dim contiguous (stride ld);
// the contraction runs over head_dim. Reads: A[g][c], B[8j + g][c] with
// c = 8 ks + t (+4).
//
// The tensor cores round an mma's fp32 sum toward zero, an error of up to
// an ulp of the accumulator that has one sign along a chain, so a chain
// drifts with its length and with what it holds when each term comes.
// The small terms of every k-step go in first, while the chain holds
// little, then the big ones: at head_dim 128 that keeps a key seen by one
// query within the reference's scale, where the three passes of each
// k-step in turn (48 mma's) left dV at 1.4x the gate against float64 (a
// CPU model in tests/test_torch_flash_kernel.py). Longer contractions (the
// wide kernels' score_piece, the forward's accumulate_pv) chain at most a
// few k-steps into a fresh accumulator added with an fp32 add, which
// rounds to nearest.
template <int kDT, int kNT>
__device__ __forceinline__ void product_nt(const float* A0, const float* B0,
                                           float acc0[kNT][4], const float* A1,
                                           const float* B1, float acc1[kNT][4],
                                           int dt) {
  constexpr int ld = ld_of<kDT>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int off = g * ld + t;
  A0 += off;
  B0 += off;
  A1 += off;
  B1 += off;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {  // the small terms, then the big ones
#pragma unroll
    for (int ks = 0; ks < kDT; ++ks) {
      if (ks < dt) {
        const int c = 8 * ks;
        const float a0[4] = {A0[c], A0[8 * ld + c], A0[c + 4], A0[8 * ld + c + 4]};
        const float a1[4] = {A1[c], A1[8 * ld + c], A1[c + 4], A1[8 * ld + c + 4]};
        uint32_t ab0[4], as0[4], ab1[4], as1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split(a0[i], ab0[i], as0[i]);
          split(a1[i], ab1[i], as1[i]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t bb0[2], bs0[2], bb1[2], bs1[2];
          split(B0[8 * j * ld + c], bb0[0], bs0[0]);
          split(B0[8 * j * ld + c + 4], bb0[1], bs0[1]);
          split(B1[8 * j * ld + c], bb1[0], bs1[0]);
          split(B1[8 * j * ld + c + 4], bb1[1], bs1[1]);
          if (pass == 0) {
            mma_tf32(acc0[j], as0, bb0);
            mma_tf32(acc0[j], ab0, bs0);
            mma_tf32(acc1[j], as1, bb1);
            mma_tf32(acc1[j], ab1, bs1);
          } else {
            mma_tf32(acc0[j], ab0, bb0);
            mma_tf32(acc1[j], ab1, bb1);
          }
        }
      }
    }
  }
}

// acc0[j] += P0 B0[:, 8j : 8j + 8] and acc1[j] += P1 B1[:, 8j : 8j + 8]
// for the first dt of kOT n-tiles, two products taken together as in
// product_nt. P0, P1 are 16 x 8 kKT, the accumulator fragments of an
// earlier product, read at every kS-th n-tile (P[kS kk]); B0, B1 are
// row-major at the kDT bucket's stride ld, read at rows 8 kS kk + 0..7 for
// columns 8j..8j + 7. The contraction runs over P's columns = B's rows,
// visited inside each k-step in the order 0, 2, 4, 6, 1, 3, 5, 7, so that
// P's fragment is the A operand as it stands. Reads:
// B[8 kS kk + 2t (+1)][8j + g].
template <int kDT, int kKT, int kS, int kOT = kDT>
__device__ __forceinline__ void product_pn(const float P0[][4], const float* B0,
                                           float acc0[kOT][4], const float P1[][4],
                                           const float* B1, float acc1[kOT][4],
                                           int dt) {
  constexpr int ld = ld_of<kDT>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  B0 += 2 * t * ld + g;
  B1 += 2 * t * ld + g;
#pragma unroll
  for (int kk = 0; kk < kKT; ++kk) {
    const int pk = kS * kk, row = 8 * kS * kk * ld;
    const float a0[4] = {P0[pk][0], P0[pk][2], P0[pk][1], P0[pk][3]};
    const float a1[4] = {P1[pk][0], P1[pk][2], P1[pk][1], P1[pk][3]};
    uint32_t ab0[4], as0[4], ab1[4], as1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split(a0[i], ab0[i], as0[i]);
      split(a1[i], ab1[i], as1[i]);
    }
#pragma unroll
    for (int j = 0; j < kOT; ++j) {
      if (j < dt) {
        const float b0[2] = {B0[row + 8 * j], B0[row + ld + 8 * j]};
        const float b1[2] = {B1[row + 8 * j], B1[row + ld + 8 * j]};
        mma3(acc0[j], ab0, as0, b0);
        mma3(acc1[j], ab1, as1, b1);
      }
    }
  }
}

template <int kN>
__device__ __forceinline__ void zero(float acc[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// -- asynchronous copies -------------------------------------------------------------

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes,
                                         bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = in ? bytes : 0;  // 0 source bytes: the destination is zero-filled
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Rows [row0, row0 + kRows) of one head of a [b, s, h, d] tensor (base
// already at the batch, head and first column) into dst [kRows][ld], d
// columns; rows at or past `rows` are zero. Neighbouring threads copy
// neighbouring 16-byte pieces of a row; kN threads in the block.
template <int kRows, int kN = kThreads>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* base,
                                          int64_t s_stride, int row0, int rows,
                                          int d) {
  const int d4 = d / 4;
  for (int i = threadIdx.x; i < kRows * d4; i += kN) {
    const int r = i / d4, c4 = i - r * d4;
    const bool in = row0 + r < rows;
    cp_async(dst + r * ld + 4 * c4, base + (int64_t)(in ? row0 + r : 0) * s_stride + 4 * c4, 16, in);
  }
}

// 8 bf16 values (16 bytes, raw) widened to fp32 into dst[0, 8).
__device__ __forceinline__ void widen_bf16x8(float* dst, uint4 raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  float4* out = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[2 * u]));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[2 * u + 1]));
    out[u] = make_float4(a.x, a.y, b.x, b.y);
  }
}

// load_tile for bf16 rows: 8 elements (16 bytes) per thread and step, read
// into registers and widened to fp32 in dst (cp.async copies bytes, it
// cannot widen them). Synchronous: the barrier after it publishes the tile.
template <int kRows, int kN = kThreads>
__device__ __forceinline__ void load_tile_bf16(float* dst, int ld, const __nv_bfloat16* base,
                                               int64_t s_stride, int row0, int rows, int d) {
  const int d8 = d / 8;
  for (int i = threadIdx.x; i < kRows * d8; i += kN) {
    const int r = i / d8, c8 = i - r * d8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) raw = __ldg(reinterpret_cast<const uint4*>(base + (int64_t)(row0 + r) * s_stride) + c8);
    widen_bf16x8(dst + r * ld + 8 * c8, raw);
  }
}

// A fragment's value as the next product's operand: itself for fp32
// operands, rounded to bf16 (nearest even, the reference's astype) and
// read back in fp32 for bf16 operands.
template <typename T>
__device__ __forceinline__ float operand(float x) {
  if constexpr (sizeof(T) == 4)
    return x;
  else
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int kN>
__device__ __forceinline__ void round_operands(float f[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[j][e] = operand<T>(f[j][e]);
}

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  return qi < p.sq && kj < p.sk && (!p.causal || qi >= kj);
}

// Rows r0 (acc[j][0..1]) and r0 + 8 (acc[j][2..3]) of a contiguous
// [b, s, h, d] output (out already at the lane's first n-tile), the
// first dt of kDT n-tiles, kStep n-tiles apart; rows at or past s are
// skipped. A bf16 output (T = __nv_bfloat16) is rounded to nearest even.
template <int kDT, typename T = float, int kStep = 1>
__device__ __forceinline__ void store_rows(T* out, int ib, int ih, int h,
                                           int s, int r0, int d, int dt,
                                           const float acc[kDT][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= s) continue;
    T* o = out + (((int64_t)ib * s + row) * h + ih) * d + 2 * t;
#pragma unroll
    for (int j = 0; j < kDT; ++j)
      if (j < dt) {
        if constexpr (sizeof(T) == 4)
          *reinterpret_cast<float2*>(o + 8 * kStep * j) = make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * kStep * j) =
              __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
      }
  }
}

// What one block of `kernel` takes and how many fit an SM: out =
// {registers per thread, local (spill) bytes per thread, dynamic shared
// bytes, threads, blocks per SM}.
inline int occupancy(const void* kernel, size_t smem, int* out, int threads = kThreads) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = threads;
  out[4] = blocks;
  return 0;
}

}  // namespace flash
