// Flash attention forward and backward for Hopper (sm_90a) on bf16 operands:
// the device bodies of kernels #1, #2 and #3 under mixed precision. Built by
// flexflow_tpu_torch/ops/cuda/_build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes by
// flexflow_tpu_torch/ops/cuda/flash_kernel.py. The fp32 bodies are
// csrc/flash_kernel.cu (#1) and csrc/flash_bwd_kernel.cu (#2, #3; its wide
// kernels also take #2 and #3 at bf16 past head_dim 256); this file shares
// their block shape and cp.async staging (csrc/flash_common.cuh).
//
// What it replaces: the Pallas TPU kernels of
// flexflow_tpu/ops/pallas/flash_kernel.py at bf16 inputs, which keep f32
// scratch accumulators and an f32 LSE and cast the second product's
// operand to the input dtype:
//   * flash_fwd_bf16_kernel (head_dim up to 256) and
//     flash_fwd_wide_bf16_kernel (past it, any multiple of 8) replace
//     _fwd_kernel (:129, pallas_call :198):
//     S = scale Q K^T in f32, the online softmax in f32, P rounded to bf16
//     (:158) for O += P V in f32; O = acc / max(l, 1e-30) rounded to bf16,
//     LSE = m + log(max(l, 1e-30)) in f32;
//   * flash_dq_bf16_kernel replaces _dq_kernel (:230, pallas_call :384):
//     P = exp(S - LSE), dP = dO V^T in f32, dS = P (dP - delta) scale
//     rounded to bf16 (:260), dQ = dS K in f32, rounded to bf16;
//   * flash_dkv_bf16_kernel replaces _dkv_kernel (:269, pallas_call :419):
//     dV = bf16(P)^T dO (:297) and dK = bf16(dS)^T Q (:306) in f32, each
//     rounded to bf16.
// Rounding is round-to-nearest-even (cvt.rn), as astype does; masked
// entries weigh exactly 0; causal is qpos >= kpos from a shared origin.
//
// What bounds it: operations. At the flagship shape (b 8, s 512, h 16,
// d 64) #1 does 8.59 GFLOP against 33.8 MB (254 flops a byte), #2 12.9
// GFLOP against 42.5 MB and #3 17.2 GFLOP against 50.9 MB; at 989 TFLOP/s of
// dense bf16 and 3.35 TB/s that is 0.0087-0.0174 ms of products against
// 0.0101-0.0152 ms of bytes. The design is the simple one first:
//   * mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, one pass per
//     product: a bf16 x bf16 product is exact in f32, so no split.
//   * A block of 4 warps owns a 64-row tile of its fixed operand (queries
//     for #1 and #2, keys for #3), 16 rows a warp, and loops over 64-row
//     tiles of the other operand, double-buffered with cp.async up to
//     head_dim 128 (single-buffered past it, where the tiles take 135 KB).
//     The loop takes the place of the TPU's sequential grid axis.
//   * Scores live in m16n8 f32 accumulator fragments. Two adjacent n8
//     tiles of them, rounded to bf16 and packed in pairs, are the k16 A
//     fragment of the next product as they stand (lane (g, t) holds
//     columns 2t, 2t + 1 of both tiles, which are the A fragment's k
//     columns 2t, 2t + 1 and 2t + 8, 2t + 9): no shared-memory round trip.
//   * Operands whose contraction runs over head_dim (Q, K in S = Q K^T; dO,
//     V in dP) are read from shared memory as 32-bit pairs of bf16 (with
//     ldmatrix.x4 in the wide forward). Those
//     whose contraction runs over the tile's rows (V in P V, K in dS K, dO
//     and Q in #3) are B operands in transpose and are read with
//     ldmatrix.x4.trans, two n8 tiles a load.
//   * #3 computes S^T = K Q^T and dP^T = V dO^T, so an accumulator row is
//     one of the warp's own keys and P^T, dS^T are A fragments directly.
//   * Tiles are staged row-major at a stride of kD + 8 bf16 (kD the
//     head_dim bucket 32, 64, 128 or 256): the 32-bit fragment reads and
//     ldmatrix's 16-byte rows are then free of bank conflicts. Columns from
//     head_dim to the next multiple of 16 are zero-filled, so the last
//     k16 step of a head_dim like 24 or 136 adds nothing.
//   * head_dim past 128: a grid z index picks a chunk of the output
//     columns (at most 128 for #1 and #2, 64 for #3, whose two
//     accumulators would not fit the registers at 128), and the score
//     products are recomputed once per chunk. #2 and #3 past head_dim 256
//     are refused here (takes(); the wrapper sends them to
//     flash_bwd_kernel.cu's wide kernels).
//   * fp32 accumulators chain through a tile's mma's: the tensor cores'
//     round-toward-zero of an mma's sum (flash_common.cuh, product_nt) is
//     far below a bf16 output's ulp, but for the backward's dP where
//     dP - delta cancels: from head_dim 128 its score products take a
//     fresh accumulator per k-step (scores()).
//
// #1 past head_dim 256 (flash_fwd_wide_bf16_kernel; it replaced the fp32
// file's wide kernel instantiated for bf16, which widened every staged
// value to f32 for one TF32 pass). Its bound at [8, 512, 4, 320]: 10.7
// GFLOP (0.0109 ms at 989 TFLOP/s) against 41.9 MB (0.0125 ms at 3.35
// TB/s), so bytes; with the scores recomputed per output chunk (3 at 320)
// the products are 21.5 GFLOP. What the design does about each cause of
// the replaced body's 39x over that bound:
//   * widened operands and TF32 products: operands stay bf16 from device
//     memory to the tensor cores (cp.async copies, one m16n8k16 bf16 pass,
//     half the instructions of m16n8k8 TF32 at twice the rate), and the
//     score operands are read with ldmatrix.x4, a whole A fragment or two
//     n-tiles' B fragments a load;
//   * Q staged again for every key tile and piece: the block's 128 query
//     rows (8 warps of 16) stay resident at full head_dim (stride
//     width16(d) + 8) and feed every key tile's A fragments, up to
//     kWideResidentD, the widest head_dim whose Q tile fits beside the ring
//     below in 232,448 bytes (752 with 2 slots of 128 columns); past it the
//     Q pieces ride in the ring beside their K pieces (slots of 64 + 128
//     rows), so any multiple of 8 runs here. 8 warps, not 4, so that each
//     staged K and V byte feeds 128 queries: measured on an H100 at [8,
//     512, 4, 320], the loads alone (no products) took 0.115 ms of the 4-warp
//     body's 0.202;
//   * no overlap: the block's loads are one stream of items (each key
//     tile's head_dim pieces of K, then its pieces of the block's V chunk)
//     through a ring of kWideStages slots filled by cp.async, kWideStages -
//     1 items ahead: each item's copy is issued before the product of the
//     item before it starts, and one barrier an item frees the oldest slot
//     (3 or 4 slots measured within 2% of 2 at 320 and slower at 512, where
//     they cost the second block of an SM); the products of a full K piece
//     and of the V chunk, staged at the full piece width with zeros past
//     the chunk, run with no test per k-step or n-tile (dropping the tests
//     took 26% off the 4-warp body at [8, 256, 2, 512]);
//   * scores recomputed per output chunk: kept (grid z chunks of at most
//     128 output columns, 64 f32 registers of O a thread; ceil(d / 128)
//     score passes a key tile), the price of keeping O in registers.
// Causal handling is flash_fwd_bf16_kernel's. Each piece's k16 steps chain
// into a fresh accumulator added to the scores in f32, so at most 8 mma
// sums a chain are truncated, whatever head_dim is.

#include <cuda_bf16.h>

#include "flash_common.cuh"

namespace {

using flash::cp_async;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::cp_async_wait_all;
using flash::kThreads;
using flash::kTile;
using flash::z_chunk;

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;         // rows of a loop tile (keys in #1, #2; queries in #3)
constexpr int kSN = kRows / 8;    // 8-wide n-tiles of a warp's 16 x kRows scores
constexpr int kStagedD = 256;     // widest head_dim staged at full width (buckets 0-3)
constexpr int kFwdOT = 16;        // output n-tiles of one block of #1 and #2
constexpr int kDkvOT = 8;         // output n-tiles of one block of #3
constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;    // dO [b, sq, h, d] (backward)
  const float* lse;    // [b, h, sq] (backward)
  const float* delta;  // [b, h, sq], rowsum(dO * O) - g_lse (backward)
  bf16* out0;          // O, dQ or dK (contiguous [b, s, h, d])
  bf16* out1;          // dV (contiguous [b, sk, h, d])
  float* lse_out;      // LSE [b, h, sq] (forward)
  int h, sq, sk, d;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t g_sb, g_ss, g_sh;
  float scale;
  int causal;
};

// #1 at any positive multiple of 8; #2 and #3 up to kStagedD
bool takes(int kind, int d) { return d > 0 && d % 8 == 0 && (kind == kFwd || d <= kStagedD); }

// head_dim bucket kD = 32, 64, 128 or 256, or 4: #1 past kStagedD
int bucket(int d) { return d <= 32 ? 0 : d <= 64 ? 1 : d <= 128 ? 2 : d <= kStagedD ? 3 : 4; }

template <int kD>
__host__ __device__ constexpr int ld_of() { return kD + 8; }

// output n-tiles of one block: all of the bucket's, at most kMax
template <int kD, int kMax>
__host__ __device__ constexpr int out_tiles() { return kD / 8 < kMax ? kD / 8 : kMax; }

// loop tiles in flight: 2 up to head_dim 128, 1 past it
template <int kD>
__host__ __device__ constexpr int stages() { return kD <= 128 ? 2 : 1; }

// the backward's score products take a fresh accumulator per k-step from
// head_dim bucket 128 (8 or more k-steps; see scores())
template <int kD>
__host__ __device__ constexpr bool fresh() { return kD >= 128; }

// grid z: output-column chunks of at most max_tiles n-tiles
int chunks(int d, int max_tiles) { return (d / 8 + max_tiles - 1) / max_tiles; }

// This block's output columns: n-tiles [c0t, c0t + cn) of the head_dim's dt.
template <int kD, int kMax>
__device__ __forceinline__ void out_chunk(int dt, int& c0t, int& cn) {
  if constexpr (kD / 8 <= kMax) {
    c0t = 0;
    cn = dt;
  } else {
    z_chunk(dt, c0t, cn);
  }
}

// -- fragments ------------------------------------------------------------------------
// Lane l is (g, t) = (l / 4, l % 4). An m16n8 accumulator c[4] holds rows g
// (c[0], c[1]) and g + 8 (c[2], c[3]) at columns 2t and 2t + 1. The k16 A
// fragment a[4] holds (row g, k 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..); the B fragment b0 holds (k 2t..2t+1, column g), b1
// (k 2t + 8.., g); the lower k in the lower half of each register.

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (lo, hi) rounded to nearest even, packed with lo in the lower half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices in transpose: lane l gives the address of row
// l % 8 of matrix l / 8 and receives, of each matrix, (rows 2t, 2t + 1,
// column g) in r[i].
__device__ __forceinline__ void ldsm_t4(uint32_t r[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Four 8 x 8 bf16 matrices: lane l gives the address of row l % 8 of
// matrix l / 8 and receives, of each matrix, (row g, columns 2t, 2t + 1)
// in r[i].
__device__ __forceinline__ void ldsm4(uint32_t r[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

template <int kN>
__device__ __forceinline__ void zero(float acc[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// s[j] += A B_j^T over head_dim for the warp's 16 rows of A and kSN 8-row
// n-tiles of B, both row-major at stride ld with head_dim contiguous; s2[j]
// += A2 B2_j^T alongside (the backward's dP), when kTwo. Reads A[g][c],
// B[8j + g][c] with c = 16 ks + 2t (+8), k-steps below d.
//
// kFresh: each k-step's mma goes into a fresh accumulator that is added to
// s in f32. The tensor cores round an mma's f32 sum toward zero, so a
// chain of k-steps into one accumulator drifts with its length; where dQ
// or dK is 0 in exact arithmetic (one visible key) that drift of dP is
// all that is left of dP - delta, and at head_dim 136-256 it measured
// 4.7e-6 on an H100 against the plain version's 1.0e-6. A fresh accumulator truncates
// only one k-step's 16-term partial, and the adds round to nearest.
template <int kD, bool kTwo, bool kFresh>
__device__ __forceinline__ void scores(const bf16* A, const bf16* B, float s[kSN][4],
                                       const bf16* A2, const bf16* B2, float s2[kSN][4], int d) {
  constexpr int ld = ld_of<kD>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int off = g * ld + 2 * t;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    if (16 * ks < d) {
      const int c = off + 16 * ks;
      const uint32_t a[4] = {ld32(A + c), ld32(A + c + 8 * ld), ld32(A + c + 8), ld32(A + c + 8 * ld + 8)};
      uint32_t a2[4];
      if constexpr (kTwo) {
        a2[0] = ld32(A2 + c);
        a2[1] = ld32(A2 + c + 8 * ld);
        a2[2] = ld32(A2 + c + 8);
        a2[3] = ld32(A2 + c + 8 * ld + 8);
      }
#pragma unroll
      for (int j = 0; j < kSN; ++j) {
        const bf16* b = B + 8 * j * ld + c;
        if constexpr (kFresh) {
          float f[4] = {0.f, 0.f, 0.f, 0.f};
          mma(f, a, ld32(b), ld32(b + 8));
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += f[e];
        } else {
          mma(s[j], a, ld32(b), ld32(b + 8));
        }
        if constexpr (kTwo) {
          const bf16* b2 = B2 + 8 * j * ld + c;
          if constexpr (kFresh) {
            float f2[4] = {0.f, 0.f, 0.f, 0.f};
            mma(f2, a2, ld32(b2), ld32(b2 + 8));
#pragma unroll
            for (int e = 0; e < 4; ++e) s2[j][e] += f2[e];
          } else {
            mma(s2[j], a2, ld32(b2), ld32(b2 + 8));
          }
        }
      }
    }
  }
}

// The warp's 16 x kRows f32 fragments P as the k16 A fragments of the
// next product: rounded to bf16 and packed in pairs (a[kk] covers columns
// 16 kk .. 16 kk + 15).
__device__ __forceinline__ void pack_p(const float P[kSN][4], uint32_t a[kSN / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < kSN / 2; ++kk) {
    a[kk][0] = pack(P[2 * kk][0], P[2 * kk][1]);
    a[kk][1] = pack(P[2 * kk][2], P[2 * kk][3]);
    a[kk][2] = pack(P[2 * kk + 1][0], P[2 * kk + 1][1]);
    a[kk][3] = pack(P[2 * kk + 1][2], P[2 * kk + 1][3]);
  }
}

// acc[j] += P B[:, 8j : 8j + 8] over the tile's kRows rows of B for the
// first cn of kOT n-tiles (kAll: all kOT, B staged that wide): P packed by
// pack_p; B row-major at stride ld (already at the first output column),
// read in transpose with ldmatrix, two n-tiles a load (kOT is even; a pair
// past cn reads staged padding whose columns go unused).
template <int kOT, bool kAll = false>
__device__ __forceinline__ void product_pv(const uint32_t a[kSN / 2][4], const bf16* B, int ld,
                                           float acc[kOT][4], int cn) {
  const int lane = threadIdx.x & 31;
  const bf16* bl = B + (lane & 15) * ld + 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < kSN / 2; ++kk) {
#pragma unroll
    for (int jp = 0; jp < kOT / 2; ++jp) {
      if (kAll || 2 * jp < cn) {
        uint32_t b[4];
        ldsm_t4(b, bl + 16 * kk * ld + 16 * jp);
        mma(acc[2 * jp], a[kk], b[0], b[1]);
        if (kAll || 2 * jp + 1 < cn) mma(acc[2 * jp + 1], a[kk], b[2], b[3]);
      }
    }
  }
}

// product_pv of the warp's f32 fragments P, rounded to bf16 here.
template <int kOT>
__device__ __forceinline__ void product_pb(const float P[kSN][4], const bf16* B, int ld,
                                           float acc[kOT][4], int cn) {
  uint32_t a[kSN / 2][4];
  pack_p(P, a);
  product_pv<kOT>(a, B, ld, acc, cn);
}

// -- staging ----------------------------------------------------------------------------

// Rows [row0, row0 + kN) of one head of a [b, s, h, d] bf16 tensor (base
// already at the batch, head and first column) into dst [kN][ld]: `width`
// columns in 16-byte pieces, of which those at or past `cols` and the rows
// at or past `rows` are zero-filled; by the block's kNThreads threads.
template <int kN, int kNThreads = kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* base, int64_t s_stride,
                                          int row0, int rows, int cols, int width) {
  const int n8 = width / 8;
  for (int i = threadIdx.x; i < kN * n8; i += kNThreads) {
    const int r = i / n8, c8 = i - r * n8;
    const bool in = row0 + r < rows && 8 * c8 < cols;
    cp_async(dst + r * ld + 8 * c8, base + (in ? (int64_t)(row0 + r) * s_stride + 8 * c8 : 0), 16, in);
  }
}

// head_dim rounded up to the mma's k16
__device__ __forceinline__ int width16(int d) { return (d + 15) & ~15; }

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  return qi < p.sq && kj < p.sk && (!p.causal || qi >= kj);
}

// Rows r0 and r0 + 8 of a contiguous [b, s, h, d] bf16 output (out already
// at the block's first column), the first cn of kOT n-tiles, rounded to
// nearest even; rows at or past s are skipped.
template <int kOT>
__device__ __forceinline__ void store_rows(bf16* out, int ib, int ih, int h, int s, int r0, int d,
                                           int cn, const float acc[kOT][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= s) continue;
    bf16* o = out + (((int64_t)ib * s + row) * h + ih) * d + 2 * t;
#pragma unroll
    for (int j = 0; j < kOT; ++j)
      if (j < cn) *reinterpret_cast<uint32_t*>(o + 8 * j) = pack(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

// -- #1 forward ---------------------------------------------------------------------------

// The online softmax over one tile's scores of rows r0, r0 + 8 (keys
// k0 + 8j + 2t (+1)) in base 2: s becomes P = 2^(s scale log2(e) - m_new),
// exactly 0 where masked (kMasked); the running max m (base 2), the lane's
// partial row sums l of the f32 P and O are rescaled to the new max.
template <bool kMasked, int kOT>
__device__ __forceinline__ void softmax_tile(const Params& p, int r0, int k0, float s[kSN][4],
                                             float m[2], float l[2], float o[kOT][4]) {
  const int t = threadIdx.x & 3;
  float mx[2] = {kMask, kMask};
#pragma unroll
  for (int j = 0; j < kSN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      s[j][e] *= p.scale * kLog2e;
      if (!kMasked || visible(p, r0 + 8 * i, k0 + 8 * j + 2 * t + (e & 1))) mx[i] = fmaxf(mx[i], s[j][e]);
    }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < kSN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const bool ok = !kMasked || visible(p, r0 + 8 * i, k0 + 8 * j + 2 * t + (e & 1));
      s[j][e] = ok ? exp2f(s[j][e] - m[i]) : 0.f;
      l[i] += s[j][e];
    }
#pragma unroll
  for (int j = 0; j < kOT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
}

__host__ __device__ constexpr int fwd_min_blocks(int kD) { return kD <= 64 ? 4 : kD <= 128 ? 2 : 1; }

template <int kD>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks(kD)) flash_fwd_bf16_kernel(const Params p) {
  constexpr int kOT = out_tiles<kD, kFwdOT>();
  constexpr int ld = ld_of<kD>(), vld = 8 * kOT + 8;
  constexpr int ktile = kRows * ld, vtile = kRows * vld;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // Q [64][ld]
  bf16* ks = qs + kTile * ld;                  // K [2][kRows][ld]
  bf16* vs = ks + 2 * ktile;                   // V [2][kRows][vld], this block's columns
  const int d = p.d, dt = d / 8, dw = width16(d);
  int c0t, cn;
  out_chunk<kD, kFwdOT>(dt, c0t, cn);
  const int c0 = 8 * c0t, vw = 16 * ((cn + 1) / 2);
  const int q0 = blockIdx.x * kTile, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* kb = p.k + ib * p.k_sb + ih * p.k_sh;
  const bf16* vb = p.v + ib * p.v_sb + ih * p.v_sh + c0;
  load_tile<kTile>(qs, ld, p.q + ib * p.q_sb + ih * p.q_sh, p.q_ss, q0, p.sq, d, dw);
  load_tile<kRows>(ks, ld, kb, p.k_ss, 0, p.sk, d, dw);
  load_tile<kRows>(vs, vld, vb, p.v_ss, 0, p.sk, 8 * cn, vw);
  cp_async_commit();

  const int w0 = q0 + 16 * warp, r0 = w0 + g;  // this lane's rows r0, r0 + 8
  const bf16* qw = qs + 16 * warp * ld;
  float o[kOT][4];
  zero<kOT>(o);
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  const int k_end = p.causal ? min(p.sk, q0 + kTile) : p.sk;
  const int n = (k_end + kRows - 1) / kRows;
  for (int it = 0; it < n; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if (it + 1 < n) {
      const int nb = (it + 1) & 1;
      load_tile<kRows>(ks + nb * ktile, ld, kb, p.k_ss, (it + 1) * kRows, p.sk, d, dw);
      load_tile<kRows>(vs + nb * vtile, vld, vb, p.v_ss, (it + 1) * kRows, p.sk, 8 * cn, vw);
      cp_async_commit();
    }
    const int k0 = it * kRows;
    if (p.causal && w0 + 15 < k0) continue;  // the warp's rows see none of these keys
    float s[kSN][4];
    zero<kSN>(s);
    scores<kD, false, false>(qw, ks + (it & 1) * ktile, s, nullptr, nullptr, nullptr, d);
    const bool all = w0 + 16 <= p.sq && k0 + kRows <= p.sk && (!p.causal || w0 >= k0 + kRows - 1);
    if (all)
      softmax_tile<false, kOT>(p, r0, k0, s, m, l, o);
    else
      softmax_tile<true, kOT>(p, r0, k0, s, m, l, o);
    product_pb<kOT>(s, vs + (it & 1) * vtile, vld, o, cn);  // O += bf16(P) V
  }
  cp_async_wait_all();  // nothing in flight when the block exits

  float lnz[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lnz[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < kOT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] /= lnz[e >> 1];
  store_rows<kOT>(p.out0 + c0, ib, ih, p.h, p.sq, r0, d, cn, o);
  if (blockIdx.z == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r < p.sq) p.lse_out[((int64_t)ib * p.h + ih) * p.sq + r] = (m[i] + log2f(lnz[i])) * kLn2;
    }
  }
}

// -- #1 past head_dim 256 ------------------------------------------------------------------

constexpr int kWidePT = kFwdOT;  // n-tiles of one streamed piece of head_dim (and of the V chunk)
constexpr int kWideLd = 8 * kWidePT + 8;  // stride of a ring slot
constexpr int kWideStages = 2;   // ring slots
constexpr int kWideWarps = 8;    // 16 query rows each
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideQ = 16 * kWideWarps;  // query rows of a block
constexpr int kSmemMax = 232448;  // dynamic shared memory one block may take

// Widest head_dim (a multiple of 16) whose resident Q tile [kWideQ][d + 8]
// fits beside the ring of kWideStages slots of kRows x kWideLd bf16.
constexpr int kWideResidentD = ((kSmemMax / 2 - kWideStages * kRows * kWideLd) / kWideQ - 8) / 16 * 16;
static_assert(kWideResidentD == 752, "the source's header states this width");

// s[j] += A B_j^T over one piece of head_dim, its kw columns (a multiple
// of 16, at most 8 kWidePT; kFull: all of them, with no test per k-step):
// the warp's 16 rows of A at stride lda and the kSN 8-row n-tiles of B at
// stride kWideLd, both read with ldmatrix.x4 (A's whole fragment; B's two
// n-tiles a load). The piece's k-steps chain into a fresh accumulator
// added to s in f32 (the header says why).
template <bool kFull>
__device__ __forceinline__ void scores_piece(const bf16* A, int lda, const bf16* B, float s[kSN][4],
                                             int kw) {
  constexpr int ldb = kWideLd;
  const int lane = threadIdx.x & 31;
  const bf16* al = A + (lane & 15) * lda + 8 * (lane >> 4);
  const bf16* bl = B + ((lane & 7) + 8 * (lane >> 4)) * ldb + 8 * ((lane >> 3) & 1);
  float f[kSN][4];
  zero<kSN>(f);
#pragma unroll
  for (int ks = 0; ks < kWidePT / 2; ++ks) {
    if (kFull || 16 * ks < kw) {
      uint32_t a[4];
      ldsm4(a, al + 16 * ks);
#pragma unroll
      for (int jp = 0; jp < kSN / 2; ++jp) {
        uint32_t b[4];
        ldsm4(b, bl + 16 * jp * ldb + 16 * ks);
        mma(f[2 * jp], a, b[0], b[1]);
        mma(f[2 * jp + 1], a, b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kSN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += f[j][e];
}

// #1 at any head_dim past kStagedD (the header's design). Grid: (query
// tiles of kWideQ rows, b h, output chunks). The block's loads are one
// stream of items, per key tile kp pieces of K over head_dim (with their Q
// pieces when Q is streamed), then its V chunk (staged at the full piece
// width, zero past the chunk, so that P V runs with no test per n-tile),
// staged into ring slot j % kWideStages. Every barrier is reached by all
// warps: a warp whose rows see none of a causal tile skips only its
// products.
__global__ void __launch_bounds__(kWideThreads, 1) flash_fwd_wide_bf16_kernel(const Params p) {
  constexpr int kP = 8 * kWidePT, ld = kWideLd, kQ = kWideQ, kStages = kWideStages;
  extern __shared__ float4 smem4[];
  const int d = p.d, dt = d / 8, dw = width16(d), qld = dw + 8;
  const bool resident = dw <= kWideResidentD;
  const int slot = (resident ? kRows : kRows + kQ) * ld;  // a K piece (and its Q piece) or a V piece
  bf16* ring = reinterpret_cast<bf16*>(smem4);           // [kStages][slot]
  bf16* qs = ring + kStages * slot;                       // resident Q [kQ][qld]
  int c0t, cn;
  z_chunk(dt, c0t, cn);
  const int c0 = 8 * c0t;
  const int q0 = blockIdx.x * kQ, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* qb = p.q + ib * p.q_sb + ih * p.q_sh;
  const bf16* kb = p.k + ib * p.k_sb + ih * p.k_sh;
  const bf16* vb = p.v + ib * p.v_sb + ih * p.v_sh + c0;
  const int kp = (dw + kP - 1) / kP, per = kp + 1;
  const int k_end = p.causal ? min(p.sk, q0 + kQ) : p.sk;
  const int n = (k_end + kRows - 1) / kRows, items = n * per;

  // item j into its slot, then a commit (an empty group past the last
  // item keeps one group per item for cp_async_wait)
  auto stage = [&](int item) {
    if (item < items) {
      const int it = item / per, r = item - it * per;
      bf16* dst = ring + (item % kStages) * slot;
      if (r < kp) {
        const int col = r * kP, w = min(kP, dw - col);
        load_tile<kRows, kWideThreads>(dst, ld, kb + col, p.k_ss, it * kRows, p.sk, d - col, w);
        if (!resident)
          load_tile<kQ, kWideThreads>(dst + kRows * ld, ld, qb + col, p.q_ss, q0, p.sq, d - col, w);
      } else {
        load_tile<kRows, kWideThreads>(dst, ld, vb, p.v_ss, it * kRows, p.sk, 8 * cn, kP);
      }
    }
    cp_async_commit();
  };
  if (resident) load_tile<kQ, kWideThreads>(qs, qld, qb, p.q_ss, q0, p.sq, d, dw);  // in item 0's group
  for (int j = 0; j < kStages - 1; ++j) stage(j);

  const int w0 = q0 + 16 * warp, r0 = w0 + g;  // this lane's rows r0, r0 + 8
  float o[kFwdOT][4];
  zero<kFwdOT>(o);
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  int j = 0;  // the item in hand
  for (int it = 0; it < n; ++it) {
    const int k0 = it * kRows;
    const bool sees = !(p.causal && w0 + 15 < k0);
    float s[kSN][4];
    zero<kSN>(s);
    for (int pc = 0; pc < kp; ++pc, ++j) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // item j is in; every warp is done with item j - 1, whose slot j + kStages - 1 takes
      stage(j + kStages - 1);
      const bf16* kt = ring + (j % kStages) * slot;
      const bf16* qa = resident ? qs + 16 * warp * qld + pc * kP : kt + (kRows + 16 * warp) * ld;
      const int kw = min(kP, dw - pc * kP), lda = resident ? qld : ld;
      if (sees && kw == kP)
        scores_piece<true>(qa, lda, kt, s, kw);
      else if (sees)
        scores_piece<false>(qa, lda, kt, s, kw);
    }
    uint32_t pa[kSN / 2][4];
    if (sees) {
      const bool all = w0 + 16 <= p.sq && k0 + kRows <= p.sk && (!p.causal || w0 >= k0 + kRows - 1);
      if (all)
        softmax_tile<false, kFwdOT>(p, r0, k0, s, m, l, o);
      else
        softmax_tile<true, kFwdOT>(p, r0, k0, s, m, l, o);
      pack_p(s, pa);  // bf16(P) for O += P V; l summed the f32 P
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // as above
    stage(j + kStages - 1);
    if (sees) product_pv<kFwdOT, true>(pa, ring + (j % kStages) * slot, ld, o, cn);  // O += bf16(P) V
    ++j;
  }
  cp_async_wait_all();  // nothing in flight when the block exits

  float lnz[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lnz[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int jj = 0; jj < kFwdOT; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[jj][e] /= lnz[e >> 1];
  store_rows<kFwdOT>(p.out0 + c0, ib, ih, p.h, p.sq, r0, d, cn, o);
  if (blockIdx.z == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r < p.sq) p.lse_out[((int64_t)ib * p.h + ih) * p.sq + r] = (m[i] + log2f(lnz[i])) * kLn2;
    }
  }
}

// -- #2 dQ ----------------------------------------------------------------------------------

// dS of the warp's 16 x kRows scores in place of dP: P = exp(s scale -
// lse), dS = P (dP - delta) scale in f32, 0 where masked (kMasked), for
// rows r0, r0 + 8 and keys k0 + 8j + 2t (+1).
template <bool kMasked>
__device__ __forceinline__ void ds_rows(const Params& p, int r0, int k0, const float lse[2],
                                        const float dl[2], const float s[kSN][4], float dp[kSN][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kSN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const bool ok = !kMasked || visible(p, r0 + 8 * i, k0 + 8 * j + 2 * t + (e & 1));
      const float pr = ok ? expf(s[j][e] * p.scale - lse[i]) : 0.f;
      dp[j][e] = pr * (dp[j][e] - dl[i]) * p.scale;
    }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 2) flash_dq_bf16_kernel(const Params p) {
  constexpr int kOT = out_tiles<kD, kFwdOT>(), kStages = stages<kD>();
  constexpr int ld = ld_of<kD>(), tile = kRows * ld;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // Q [64][ld]
  bf16* gs = qs + kTile * ld;                  // dO [64][ld]
  bf16* ks = gs + kTile * ld;                  // K [kStages][kRows][ld]
  bf16* vs = ks + kStages * tile;              // V [kStages][kRows][ld]
  const int d = p.d, dt = d / 8, dw = width16(d);
  int c0t, cn;  // this block's dQ columns: n-tiles [c0t, c0t + cn)
  out_chunk<kD, kFwdOT>(dt, c0t, cn);
  const int c0 = 8 * c0t;
  const int q0 = blockIdx.x * kTile, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const bf16* kb = p.k + ib * p.k_sb + ih * p.k_sh;
  const bf16* vb = p.v + ib * p.v_sb + ih * p.v_sh;
  load_tile<kTile>(qs, ld, p.q + ib * p.q_sb + ih * p.q_sh, p.q_ss, q0, p.sq, d, dw);
  load_tile<kTile>(gs, ld, p.dout + ib * p.g_sb + ih * p.g_sh, p.g_ss, q0, p.sq, d, dw);
  load_tile<kRows>(ks, ld, kb, p.k_ss, 0, p.sk, d, dw);
  load_tile<kRows>(vs, ld, vb, p.v_ss, 0, p.sk, d, dw);
  cp_async_commit();

  // this lane's query rows and their LSE and delta, read once
  const int w0 = q0 + 16 * warp, r0 = w0 + g;
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const int64_t off = ((int64_t)ib * p.h + ih) * p.sq + r;
    lse[i] = r < p.sq ? p.lse[off] : 0.f;
    dl[i] = r < p.sq ? p.delta[off] : 0.f;
  }

  float acc[kOT][4];
  zero<kOT>(acc);
  const int k_end = p.causal ? min(p.sk, q0 + kTile) : p.sk;
  const int n = (k_end + kRows - 1) / kRows;
  const bf16* qw = qs + 16 * warp * ld;
  const bf16* gw = gs + 16 * warp * ld;
  for (int it = 0; it < n; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if (kStages == 2 && it + 1 < n) {
      const int nb = (it + 1) & 1;
      load_tile<kRows>(ks + nb * tile, ld, kb, p.k_ss, (it + 1) * kRows, p.sk, d, dw);
      load_tile<kRows>(vs + nb * tile, ld, vb, p.v_ss, (it + 1) * kRows, p.sk, d, dw);
      cp_async_commit();
    }
    const int k0 = it * kRows;
    if (!(p.causal && w0 + 15 < k0)) {
      const bf16* kt = ks + (kStages == 2 ? (it & 1) * tile : 0);
      const bf16* vt = vs + (kStages == 2 ? (it & 1) * tile : 0);
      float s[kSN][4], dp[kSN][4];
      zero<kSN>(s);
      zero<kSN>(dp);
      scores<kD, true, fresh<kD>()>(qw, kt, s, gw, vt, dp, d);  // S = Q K^T, dP = dO V^T
      const bool all = w0 + 16 <= p.sq && k0 + kRows <= p.sk && (!p.causal || w0 >= k0 + kRows - 1);
      if (all)
        ds_rows<false>(p, r0, k0, lse, dl, s, dp);
      else
        ds_rows<true>(p, r0, k0, lse, dl, s, dp);
      product_pb<kOT>(dp, kt + c0, ld, acc, cn);  // dQ += bf16(dS) K
    }
    if (kStages == 1 && it + 1 < n) {
      __syncthreads();  // every warp is done with tile it
      load_tile<kRows>(ks, ld, kb, p.k_ss, (it + 1) * kRows, p.sk, d, dw);
      load_tile<kRows>(vs, ld, vb, p.v_ss, (it + 1) * kRows, p.sk, d, dw);
      cp_async_commit();
    }
  }
  cp_async_wait_all();  // nothing in flight when the block exits
  store_rows<kOT>(p.out0 + c0, ib, ih, p.h, p.sq, r0, d, cn, acc);
}

// -- #3 dK, dV ------------------------------------------------------------------------------

// LSE and delta of queries [q0, q0 + kRows) into ls, dls (0 past sq).
__device__ __forceinline__ void load_cols(const Params& p, int ib, int ih, int q0, float* ls,
                                          float* dls) {
  const int r = threadIdx.x % kRows;
  const bool in = q0 + r < p.sq;
  const int64_t off = ((int64_t)ib * p.h + ih) * p.sq + (in ? q0 + r : 0);
  if (threadIdx.x < kRows)
    cp_async(ls + r, p.lse + off, 4, in);
  else if (threadIdx.x < 2 * kRows)
    cp_async(dls + r, p.delta + off, 4, in);
}

// P^T and dS^T of the warp's 16 keys x kRows queries in place of S^T and
// dP^T, for keys r0, r0 + 8 and the tile's query columns 8j + 2t (+1),
// whose LSE and delta are lt, dlt.
template <bool kMasked>
__device__ __forceinline__ void ds_cols(const Params& p, int r0, int q0, const float* lt,
                                        const float* dlt, float s[kSN][4], float dp[kSN][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kSN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1);
      const bool ok = !kMasked || visible(p, q0 + col, r0 + 8 * (e >> 1));
      const float pr = ok ? expf(s[j][e] * p.scale - lt[col]) : 0.f;
      s[j][e] = pr;                                    // P^T
      dp[j][e] = pr * (dp[j][e] - dlt[col]) * p.scale;  // dS^T
    }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 2) flash_dkv_bf16_kernel(const Params p) {
  constexpr int kOT = out_tiles<kD, kDkvOT>(), kStages = stages<kD>();
  constexpr int ld = ld_of<kD>(), tile = kRows * ld;
  extern __shared__ float4 smem4[];
  float* ls = reinterpret_cast<float*>(smem4);  // LSE [kStages][kRows]
  float* dls = ls + kStages * kRows;             // delta [kStages][kRows]
  bf16* ks = reinterpret_cast<bf16*>(dls + kStages * kRows);  // K [64][ld]
  bf16* vs = ks + kTile * ld;                    // V [64][ld]
  bf16* qs = vs + kTile * ld;                    // Q [kStages][kRows][ld]
  bf16* gs = qs + kStages * tile;                // dO [kStages][kRows][ld]
  const int d = p.d, dt = d / 8, dw = width16(d);
  int c0t, cn;  // this block's dK and dV columns: n-tiles [c0t, c0t + cn)
  out_chunk<kD, kDkvOT>(dt, c0t, cn);
  const int c0 = 8 * c0t;
  const int k0 = blockIdx.x * kTile, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const bf16* qb = p.q + ib * p.q_sb + ih * p.q_sh;
  const bf16* gb = p.dout + ib * p.g_sb + ih * p.g_sh;
  // causal: query tiles above the diagonal see none of these keys
  const int q_start = p.causal ? k0 : 0;
  const int n = p.sq > q_start ? (p.sq - q_start + kRows - 1) / kRows : 0;
  load_tile<kTile>(ks, ld, p.k + ib * p.k_sb + ih * p.k_sh, p.k_ss, k0, p.sk, d, dw);
  load_tile<kTile>(vs, ld, p.v + ib * p.v_sb + ih * p.v_sh, p.v_ss, k0, p.sk, d, dw);
  if (n > 0) {
    load_tile<kRows>(qs, ld, qb, p.q_ss, q_start, p.sq, d, dw);
    load_tile<kRows>(gs, ld, gb, p.g_ss, q_start, p.sq, d, dw);
    load_cols(p, ib, ih, q_start, ls, dls);
  }
  cp_async_commit();

  const int w0 = k0 + 16 * warp, r0 = w0 + g;  // this lane's keys r0, r0 + 8
  float dk[kOT][4], dv[kOT][4];
  zero<kOT>(dk);
  zero<kOT>(dv);
  const bf16* kw = ks + 16 * warp * ld;
  const bf16* vw = vs + 16 * warp * ld;
  for (int it = 0; it < n; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if (kStages == 2 && it + 1 < n) {
      const int nb = (it + 1) & 1, q1 = q_start + (it + 1) * kRows;
      load_tile<kRows>(qs + nb * tile, ld, qb, p.q_ss, q1, p.sq, d, dw);
      load_tile<kRows>(gs + nb * tile, ld, gb, p.g_ss, q1, p.sq, d, dw);
      load_cols(p, ib, ih, q1, ls + nb * kRows, dls + nb * kRows);
      cp_async_commit();
    }
    const int q0 = q_start + it * kRows, cb = kStages == 2 ? it & 1 : 0;
    const bf16* qt = qs + cb * tile;
    const bf16* gt = gs + cb * tile;
    float s[kSN][4], dp[kSN][4];
    zero<kSN>(s);
    zero<kSN>(dp);
    scores<kD, true, fresh<kD>()>(kw, qt, s, vw, gt, dp, d);  // S^T = K Q^T, dP^T = V dO^T
    const bool all = q0 + kRows <= p.sq && w0 + 16 <= p.sk && (!p.causal || q0 >= w0 + 15);
    if (all)
      ds_cols<false>(p, r0, q0, ls + cb * kRows, dls + cb * kRows, s, dp);
    else
      ds_cols<true>(p, r0, q0, ls + cb * kRows, dls + cb * kRows, s, dp);
    product_pb<kOT>(s, gt + c0, ld, dv, cn);   // dV += bf16(P)^T dO
    product_pb<kOT>(dp, qt + c0, ld, dk, cn);  // dK += bf16(dS)^T Q
    if (kStages == 1 && it + 1 < n) {
      __syncthreads();  // every warp is done with tile it
      const int q1 = q_start + (it + 1) * kRows;
      load_tile<kRows>(qs, ld, qb, p.q_ss, q1, p.sq, d, dw);
      load_tile<kRows>(gs, ld, gb, p.g_ss, q1, p.sq, d, dw);
      load_cols(p, ib, ih, q1, ls, dls);
      cp_async_commit();
    }
  }
  cp_async_wait_all();  // nothing in flight when the block exits
  store_rows<kOT>(p.out0 + c0, ib, ih, p.h, p.sk, r0, d, cn, dk);
  store_rows<kOT>(p.out1 + c0, ib, ih, p.h, p.sk, r0, d, cn, dv);
}

// -- launch ----------------------------------------------------------------------------------

// bytes of dynamic shared memory of kernel `kind` at head_dim d; past
// kStagedD the ring, and the resident Q tile up to kWideResidentD
size_t smem_bytes(int kind, int d) {
  if (bucket(d) == 4) {
    const int dw = (d + 15) & ~15;
    return (dw <= kWideResidentD ? kWideStages * kRows * kWideLd + kWideQ * (dw + 8)
                                 : kWideStages * (kRows + kWideQ) * kWideLd) *
           sizeof(bf16);
  }
  const int kd = 32 << bucket(d);
  const size_t ld = kd + 8, st = kd <= 128 ? 2 : 1;
  if (kind == kFwd) {
    const int kot = kd / 8 < kFwdOT ? kd / 8 : kFwdOT;
    return ((kTile + 2 * kRows) * ld + 2 * kRows * (8 * kot + 8)) * sizeof(bf16);
  }
  if (kind == kDq) return (2 * kTile + 2 * st * kRows) * ld * sizeof(bf16);
  return (2 * kTile + 2 * st * kRows) * ld * sizeof(bf16) + 2 * st * kRows * sizeof(float);
}

void* kernel_of(int kind, int d) {
  static void* const table[3][5] = {
      {(void*)flash_fwd_bf16_kernel<32>, (void*)flash_fwd_bf16_kernel<64>,
       (void*)flash_fwd_bf16_kernel<128>, (void*)flash_fwd_bf16_kernel<256>,
       (void*)flash_fwd_wide_bf16_kernel},
      {(void*)flash_dq_bf16_kernel<32>, (void*)flash_dq_bf16_kernel<64>,
       (void*)flash_dq_bf16_kernel<128>, (void*)flash_dq_bf16_kernel<256>, nullptr},
      {(void*)flash_dkv_bf16_kernel<32>, (void*)flash_dkv_bf16_kernel<64>,
       (void*)flash_dkv_bf16_kernel<128>, (void*)flash_dkv_bf16_kernel<256>, nullptr}};
  return table[kind][bucket(d)];
}

// Sets each kernel's shared-memory cap once: its size, or past kStagedD
// the largest of any head_dim (the resident Q tile at kWideResidentD).
int configure(int kind, int d) {
  static bool configured[3][5] = {};
  const int bi = bucket(d);
  if (configured[kind][bi]) return 0;
  void* fn = kernel_of(kind, d);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes(kind, bi == 4 ? kWideResidentD : d));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  configured[kind][bi] = true;
  return 0;
}

// threads of a block of kernel `kind` at head_dim d (16 query or key rows a warp)
int threads_of(int kind, int d) { return bucket(d) == 4 ? kWideThreads : kThreads; }

int launch(int kind, const Params& p, int b, int rows, cudaStream_t stream) {
  if (!takes(kind, p.d)) return (int)cudaErrorInvalidValue;
  const int err = configure(kind, p.d);
  if (err) return err;
  const int threads = threads_of(kind, p.d), tile = 16 * (threads / 32);
  dim3 grid((rows + tile - 1) / tile, b * p.h, chunks(p.d, kind == kDkv ? kDkvOT : kFwdOT));
  void* args[] = {(void*)&p};
  cudaError_t e = cudaLaunchKernel(kernel_of(kind, p.d), grid, dim3(threads), args,
                                   smem_bytes(kind, p.d), stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ff_flash_bf16_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// What one block of kernel `kind` (0 forward, 1 dQ, 2 dK/dV) at head_dim d
// takes and how many fit an SM: out = {registers per thread, local (spill)
// bytes per thread, dynamic shared bytes, threads, blocks per SM}.
int ff_flash_bf16_occupancy(int kind, int d, int* out) {
  if (kind < kFwd || kind > kDkv || !takes(kind, d)) return (int)cudaErrorInvalidValue;
  const int err = configure(kind, d);
  if (err) return err;
  return flash::occupancy(kernel_of(kind, d), smem_bytes(kind, d), out, threads_of(kind, d));
}

// q [b, sq, h, d], k/v [b, sk, h, d] bf16 with head_dim (any multiple of
// 8) contiguous and 16-byte aligned rows (strides in elements); o contiguous [b, sq, h, d]
// bf16; lse contiguous [b, h, sq] f32. Returns cudaGetLastError() after
// the launch.
int ff_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int b,
                      int h, int sq, int sk, int d, long long q_sb, long long q_ss,
                      long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                      long long v_sb, long long v_ss, long long v_sh, float scale, int causal,
                      void* stream) {
  Params p{(const bf16*)q, (const bf16*)k, (const bf16*)v, nullptr, nullptr, nullptr,
           (bf16*)o, nullptr, (float*)lse, h, sq, sk, d,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, 0, 0, 0, scale, causal};
  return launch(kFwd, p, b, sq, (cudaStream_t)stream);
}

// As ff_flash_fwd_bf16 (head_dim up to 256) with dO [b, sq, h, d] bf16
// (strides g_*), lse and delta contiguous [b, h, sq] f32; dq contiguous
// [b, sq, h, d] bf16.
int ff_flash_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int b, int h, int sq, int sk,
                     int d, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, long long g_sb, long long g_ss, long long g_sh, float scale,
                     int causal, void* stream) {
  Params p{(const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
           (const float*)lse, (const float*)delta, (bf16*)dq, nullptr, nullptr, h, sq, sk, d,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh, scale, causal};
  return launch(kDq, p, b, sq, (cudaStream_t)stream);
}

// As ff_flash_dq_bf16, writing dk and dv contiguous [b, sk, h, d] bf16.
int ff_flash_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int b, int h,
                      int sq, int sk, int d, long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                      long long v_ss, long long v_sh, long long g_sb, long long g_ss,
                      long long g_sh, float scale, int causal, void* stream) {
  Params p{(const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
           (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, nullptr, h, sq, sk, d,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh, scale, causal};
  return launch(kDkv, p, b, sk, (cudaStream_t)stream);
}

}  // extern "C"
