// Flash attention forward and backward for Hopper (sm_90a) on bf16 operands:
// the device bodies of kernels #1, #2 and #3 under mixed precision. Built by
// flexflow_tpu_torch/ops/cuda/_build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes by
// flexflow_tpu_torch/ops/cuda/flash_kernel.py. The fp32 bodies are
// csrc/flash_kernel.cu (#1) and csrc/flash_bwd_kernel.cu (#2, #3; its wide
// kernels also take #2 and #3 at bf16 past head_dim 256). #1 up to head_dim
// 256 is built from csrc/hopper.cuh (TMA, mbarriers, wgmma); #2, #3 and #1
// past 256 share the fp32 bodies' cp.async staging (csrc/flash_common.cuh).
//
// What it replaces: the Pallas TPU kernels of
// flexflow_tpu/ops/pallas/flash_kernel.py at bf16 inputs, which keep f32
// scratch accumulators and an f32 LSE and cast the second product's
// operand to the input dtype:
//   * flash_fwd_bf16_wgmma_kernel (head_dim up to 256) and
//     flash_fwd_wide_bf16_kernel (past it, any multiple of 8) replace
//     _fwd_kernel (:129, pallas_call :198):
//     S = scale Q K^T in f32, the online softmax in f32, P rounded to bf16
//     (:158) for O += P V in f32 while l sums the f32 P; O = acc / max(l,
//     1e-30) rounded to bf16 (the wgmma body multiplies by the f32
//     reciprocal, within an f32 ulp of the quotient), LSE = m + log(max(l,
//     1e-30)) in f32;
//   * flash_dq_bf16_kernel replaces _dq_kernel (:230, pallas_call :384):
//     P = exp(S - LSE), dP = dO V^T in f32, dS = P (dP - delta) scale
//     rounded to bf16 (:260), dQ = dS K in f32, rounded to bf16;
//   * flash_dkv_bf16_kernel replaces _dkv_kernel (:269, pallas_call :419):
//     dV = bf16(P)^T dO (:297) and dK = bf16(dS)^T Q (:306) in f32, each
//     rounded to bf16.
// Rounding is round-to-nearest-even (cvt.rn), as astype does; masked
// entries weigh exactly 0; causal is qpos >= kpos from a shared origin.
//
// #1 up to head_dim 256 (flash_fwd_bf16_wgmma_kernel<kD>, kD = 64, 128,
// 192 or 256, the head_dim rounded up). What bounds it on this card, at
// the flagship shape (b 8, s 512, h 16, d 64): 33.8 MB in and out, 0.0101
// ms at 3.35 TB/s; 8.59 GFLOP of products, 0.0087 ms at 989 TFLOP/s of
// dense bf16; 33.5 M exponentials, about 0.009 ms at the SFU's 16 a clock
// per SM. The three floors are alike, so the exponentials have to run
// while the tensor cores do. The body it replaced (mma.sync m16n8k16, 4
// warps, 64-row tiles) took 7x the bound; what this design does about
// each of its causes:
//   * tensor cores at the mma.sync rate, every operand fragment a
//     shared-memory load by the warp (Q's again for every key tile): both
//     products are wgmma m64nNk16 issued by a warpgroup of 4 warps. S = Q
//     K^T reads Q and K from shared memory through descriptors (both
//     K-major, SS); O += P V takes P from registers, the f32 scores
//     rounded to bf16 and packed into the A-fragment layout where they
//     stand (RS), and V from shared memory MN-major (transpose bit), N =
//     kD. No operand passes through a thread's loads.
//   * no overlap of the softmax with the products: within a warpgroup,
//     key tile j's S is issued with tile j - 1's P V before tile j's
//     softmax (wgmma.wait_group 1 waits for S alone), so the exponentials
//     run under P V; across the block's two consumer warpgroups, each
//     issues its products in its turn on a pair of named barriers
//     (ping-pong), so that one's softmax runs under the other's products
//     (measured on an H100 at [8, 512, 16, 64]: 7% slower without it).
//   * each staged K/V byte fed 64 queries, copied by the compute threads
//     behind a barrier per tile: a producer warpgroup (one thread; its
//     registers handed to the consumers with setmaxnreg, 24 against 240)
//     issues TMA loads of the block's Q tile, then K and V tiles of kN
//     keys into a ring of kStages stages, each with a full and an empty
//     mbarrier for K and for V; two consumer warpgroups of 64 query rows
//     share every tile, so each staged byte feeds 128 queries. The tensor
//     maps are 4-D over [d, s, h, b] with the operands' own strides, in
//     boxes of 64 columns, 128-byte swizzled (hopper.cuh's layout), and
//     are encoded per call on the host. Rows past s and columns past d
//     arrive as zeros, so no k-step and no column needs a test.
//   * 1024 blocks at 4 an SM, 1.94 waves: the grid is persistent, one
//     block an SM walking the (b h) x 128-row query tiles, the last query
//     tiles (the longest when causal) first; the producer loads the next
//     tile's Q as soon as the consumers' last score product of the
//     current one is done, so the load runs under their last P V and
//     epilogue (measured: one block a tile is 15% slower).
// Tiles crossing the ragged edge or the causal diagonal of a
// warpgroup's rows test one key limit a row per entry; every other tile
// runs with no test, and causal key tiles above the diagonal are never
// loaded. kN is 128 up to head_dim 128 and 64 past it, so that O (kD / 2
// f32 a thread), S (kN / 2), P (kN / 4) and both in flight fit 240
// registers with no spill, and Q, two stages of K and V fit 227 KB (at
// 256: 64 KB + 2 x 64 KB). The epilogue stores O rows in 16-byte pieces
// after a transpose across each lane quad, and LSE in f32. No atomics, no
// split over keys: two calls give the same bits. Measured variants (an
// H100, [8, 512, 16, 64], scripts/flash_fwd_bf16_variants.py): 3 stages,
// kN 64 and three consumer warpgroups (192-row tiles) were no faster.
//
// #2 and #3 up to head_dim 256, on mma.sync:
//   * mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, one pass per
//     product: a bf16 x bf16 product is exact in f32, so no split.
//   * A block of 4 warps owns a 64-row tile of its fixed operand (queries
//     for #2, keys for #3), 16 rows a warp, and loops over 64-row tiles of
//     the other operand, double-buffered with cp.async up to head_dim 128
//     (single-buffered past it, where the tiles take 135 KB). The loop
//     takes the place of the TPU's sequential grid axis.
//   * Scores live in m16n8 f32 accumulator fragments. Two adjacent n8
//     tiles of them, rounded to bf16 and packed in pairs, are the k16 A
//     fragment of the next product as they stand (lane (g, t) holds
//     columns 2t, 2t + 1 of both tiles, which are the A fragment's k
//     columns 2t, 2t + 1 and 2t + 8, 2t + 9): no shared-memory round trip.
//   * Operands whose contraction runs over head_dim (Q, K in S = Q K^T; dO,
//     V in dP) are read from shared memory as 32-bit pairs of bf16 (with
//     ldmatrix.x4 in the wide forward). Those whose contraction runs over
//     the tile's rows (K in dS K, dO and Q in #3, V in the wide forward's
//     P V) are B operands in transpose and are read with
//     ldmatrix.x4.trans, two n8 tiles a load.
//   * #3 computes S^T = K Q^T and dP^T = V dO^T, so an accumulator row is
//     one of the warp's own keys and P^T, dS^T are A fragments directly.
//   * Tiles are staged row-major at a stride of kD + 8 bf16 (kD the
//     head_dim bucket 32, 64, 128 or 256): the 32-bit fragment reads and
//     ldmatrix's 16-byte rows are then free of bank conflicts. Columns from
//     head_dim to the next multiple of 16 are zero-filled, so the last
//     k16 step of a head_dim like 24 or 136 adds nothing.
//   * head_dim past 128: a grid z index picks a chunk of the output
//     columns (at most 128 for #2, 64 for #3, whose two accumulators
//     would not fit the registers at 128), and the score products are
//     recomputed once per chunk. #2 and #3 past head_dim 256 are refused
//     here (takes(); the wrapper sends them to flash_bwd_kernel.cu's wide
//     kernels).
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
// Causal: key tiles past the block's last row are never staged, and a
// warp whose rows see none of a key tile skips its products. Each
// piece's k16 steps chain into a fresh accumulator added to the scores
// in f32, so at most 8 mma sums a chain are truncated, whatever head_dim
// is.

#include <cuda_bf16.h>

#include "flash_common.cuh"
#include "hopper.cuh"

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

// s[j] += A B_j^T and s2[j] += A2 B2_j^T over head_dim (the backward's S
// and dP) for the warp's 16 rows of A, A2 and kSN 8-row n-tiles of B, B2,
// all row-major at stride ld with head_dim contiguous. Reads A[g][c],
// B[8j + g][c] with c = 16 ks + 2t (+8), k-steps below d.
//
// kFresh: each k-step's mma goes into a fresh accumulator that is added to
// s in f32. The tensor cores round an mma's f32 sum toward zero, so a
// chain of k-steps into one accumulator drifts with its length; where dQ
// or dK is 0 in exact arithmetic (one visible key) that drift of dP is
// all that is left of dP - delta, and at head_dim 136-256 it measured
// 4.7e-6 on an H100 against the plain version's 1.0e-6. A fresh
// accumulator truncates only one k-step's 16-term partial, and the adds
// round to nearest.
template <int kD, bool kFresh>
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
      const uint32_t a2[4] = {ld32(A2 + c), ld32(A2 + c + 8 * ld), ld32(A2 + c + 8), ld32(A2 + c + 8 * ld + 8)};
#pragma unroll
      for (int j = 0; j < kSN; ++j) {
        const bf16* b = B + 8 * j * ld + c;
        const bf16* b2 = B2 + 8 * j * ld + c;
        if constexpr (kFresh) {
          float f[4] = {0.f, 0.f, 0.f, 0.f};
          mma(f, a, ld32(b), ld32(b + 8));
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += f[e];
          float f2[4] = {0.f, 0.f, 0.f, 0.f};
          mma(f2, a2, ld32(b2), ld32(b2 + 8));
#pragma unroll
          for (int e = 0; e < 4; ++e) s2[j][e] += f2[e];
        } else {
          mma(s[j], a, ld32(b), ld32(b + 8));
          mma(s2[j], a2, ld32(b2), ld32(b2 + 8));
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

// -- #1 past head_dim 256: the softmax on mma.sync fragments -------------------------------

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

// -- #1 up to head_dim 256: wgmma over TMA-fed tiles --------------------------------------

// Shape of the forward's block at head_dim bucket kD (64, 128, 192 or
// 256; the header says why each number).
template <int kD>
struct Fwd {
  static constexpr int kWG = 2;                        // consumer warpgroups, 64 query rows each
  static constexpr int kM = 64 * kWG;                  // query rows of a block
  static constexpr int kN = kD <= 128 ? 128 : 64;      // key rows of a loop tile
  static constexpr int kStages = 2;                    // K and V tiles in flight
  static constexpr int kBoxes = kD / 64;               // 64-column TMA boxes across head_dim
  static constexpr int kThreads = 128 * (kWG + 1);     // a producer warpgroup and the consumers
  // registers a thread after setmaxnreg: 128 x 24 + 256 x 240 fit the
  // 384 x 168 the launch allocates
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static_assert(kWG == 2, "the register split is for two consumer warpgroups");
  static constexpr uint32_t kQBytes = kM * kD * 2, kKVBytes = kN * kD * 2;
  static constexpr int kBars = 2 + 4 * kStages;        // full and empty for Q, and for K and V per stage
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBars;
};

// head_dim bucket of the forward up to kStagedD
__host__ __device__ constexpr int fwd_dim(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : d <= 192 ? 192 : 256; }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax over one tile's scores s (wgmma accumulator layout)
// of rows r0, r0 + 8 and keys k0 + 8j + 2t (+1), in base 2 with the scale
// folded in (c = scale log2(e)): s becomes P = 2^(c s - c m_new), exactly
// 0 where masked (kMasked); the running max m (unscaled) and the lane's
// partial row sums l of the f32 P are updated, and corr is what O is to
// be multiplied by.
template <bool kMasked, int kN>
__device__ __forceinline__ void softmax_rows(const Params& p, float c, int r0, int k0, float (&s)[kN / 2],
                                             float m[2], float l[2], float corr[2]) {
  const int t = threadIdx.x & 3;
  // a masked tile's visible keys of row i: 8 j + (e & 1) < lim[i] (keys
  // below sk and, causal, at or before the row; rows past sq are never
  // stored, so they need no test)
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lim[i] = (p.causal ? min(p.sk, r0 + 8 * i + 1) : p.sk) - k0 - 2 * t;
  // four partial maxima and sums a row: short dependency chains
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) mx[i][q] = kMask, sum[i][q] = 0.f;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      if (!kMasked || 8 * j + (e & 1) < lim[i]) mx[i][j & 3] = fmaxf(mx[i][j & 3], s[4 * j + e]);
    }
  float mc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float x = fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[i], x);
    corr[i] = ex2((m[i] - m_new) * c);
    m[i] = m_new;
    mc[i] = m_new * c;
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const bool ok = !kMasked || 8 * j + (e & 1) < lim[i];
      s[4 * j + e] = ok ? ex2(fmaf(s[4 * j + e], c, -mc[i])) : 0.f;
      sum[i][j & 3] += s[4 * j + e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + ((sum[i][0] + sum[i][1]) + (sum[i][2] + sum[i][3]));
}

// Row `row` of O (this lane's accumulators o[4 j + 2 half], o[4 j + 2 half
// + 1], columns 8 j + 2 t, + 1) times inv, rounded to bf16, stored by the
// lane's quad in 16-byte pieces: a transpose across the quad (lane t
// takes, of each 32-column group, columns 8 t .. 8 t + 7) turns 4-byte
// stores 16 bytes apart into whole 16-byte ones. out: the row's first
// column; columns at or past d, and rows a lane does not `keep`, are not
// stored (every lane of the warp takes part in the shuffles).
template <int kD>
__device__ __forceinline__ void store_row(bf16* out, const float (&o)[kD / 2], int half, float inv, int d,
                                          bool keep) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int G = 0; G < kD / 32; ++G) {
    uint32_t a[4], w[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * G + jj;
      a[jj] = pack(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    }
    // w[k] = lane k's a[t]: in round m, lane t sends its a[t ^ m] to lane
    // t ^ m and takes lane t ^ m's a[t] in return
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = t ^ m;
      const uint32_t mine = k == 0 ? a[0] : k == 1 ? a[1] : k == 2 ? a[2] : a[3];
      const uint32_t got = m == 0 ? mine : __shfl_xor_sync(0xffffffffu, mine, m);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q == k) w[q] = got;
    }
    if (keep && 32 * G + 8 * t < d)
      *reinterpret_cast<uint4*>(out + 32 * G + 8 * t) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// S = Q K^T of the warpgroup's 64 query rows (qw) and the kN keys of one
// K stage (kt), both K-major in boxes of 64 columns (kM and kN rows).
template <int kD>
__device__ __forceinline__ void issue_scores(float (&s)[Fwd<kD>::kN / 2], const bf16* qw, const bf16* kt) {
  using F = Fwd<kD>;
  hopper::fence_regs(s);
  hopper::wgmma_fence();
#pragma unroll
  for (int b = 0; b < F::kBoxes; ++b)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaSS<F::kN, 0, 0>::run(s, hopper::desc_kmajor(qw + b * F::kM * 64 + 16 * kk),
                                        hopper::desc_kmajor(kt + b * F::kN * 64 + 16 * kk), b + kk > 0);
  hopper::wgmma_commit();
  hopper::fence_regs(s);
}

// O += P V over the kN keys of one V stage (vt, MN-major: head_dim is the
// product's N), P the bf16 A fragments pa.
template <int kD>
__device__ __forceinline__ void issue_pv(float (&o)[kD / 2], uint32_t (&pa)[Fwd<kD>::kN / 16][4],
                                         const bf16* vt) {
  using F = Fwd<kD>;
  hopper::fence_regs(o);
  hopper::fence_regs(pa);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < F::kN / 16; ++kk)
    hopper::WgmmaRS<kD, 1>::run(o, pa[kk], hopper::desc_mnmajor(vt + 16 * 64 * kk, F::kN * 128), 1);
  hopper::wgmma_commit();
  hopper::fence_regs(o);
}

// s (f32 P in the accumulator layout) as the bf16 A fragments of P V
template <int kN>
__device__ __forceinline__ void to_fragments(const float (&s)[kN / 2], uint32_t (&pa)[kN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kk][e] = pack(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// Query tile t of the forward's (b h) x (query tiles of kM rows), the
// last query tiles (the longest when causal) first: batch ib, head ih,
// first row q0, and n, the key tiles of kN rows it reads.
struct FwdTile {
  int ib, ih, q0, n;
};

template <int kD>
__device__ __forceinline__ FwdTile fwd_tile(const Params& p, int t, int bh, int mt) {
  using F = Fwd<kD>;
  FwdTile r;
  r.ib = (t % bh) / p.h;
  r.ih = t % p.h;
  r.q0 = (mt - 1 - t / bh) * F::kM;
  const int k_end = p.causal ? min(p.sk, r.q0 + F::kM) : p.sk;
  r.n = (k_end + F::kN - 1) / F::kN;
  return r;
}

// #1 at head_dim up to 256 (the header's design). Block b takes query
// tiles b, b + gridDim.x, ... (fwd_tile) of the bh x mt. Warpgroup 0 is
// the producer: one thread loads each tile's Q once, then the K and V
// tiles of kN keys into a ring of kStages stages, each with its full and
// empty mbarriers; the next query tile's Q as soon as the consumers'
// last score product of this one is done. Warpgroups 1 .. kWG each own
// 64 query rows: S = Q K^T and O += P V on wgmma, the softmax in between
// on the accumulators, the next key tile's S issued before this one's
// softmax.
template <int kD>
__global__ void __launch_bounds__(Fwd<kD>::kThreads, 1)
    flash_fwd_bf16_wgmma_kernel(const Params p, int bh, int mt, const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  using F = Fwd<kD>;
  constexpr int kN = F::kN, kS = F::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(base);  // [kBoxes][kM][64]
  bf16* ks = qs + F::kM * kD;                 // [kS][kBoxes][kN][64]
  bf16* vs = ks + kS * kN * kD;               // [kS][kBoxes][kN][64]
  uint64_t* full_q = reinterpret_cast<uint64_t*>(vs + kS * kN * kD);
  uint64_t* empty_q = full_q + 1;
  uint64_t* full_k = empty_q + 1;
  uint64_t* full_v = full_k + kS;
  uint64_t* empty_k = full_v + kS;
  uint64_t* empty_v = empty_k + kS;
  const int tiles = bh * mt;
  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    hopper::mbar_init(empty_q, F::kWG);
    for (int i = 0; i < kS; ++i) {
      hopper::mbar_init(&full_k[i], 1);
      hopper::mbar_init(&full_v[i], 1);
      hopper::mbar_init(&empty_k[i], F::kWG);
      hopper::mbar_init(&empty_v[i], F::kWG);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, warp-uniform by the shuffle: the descriptors and tile
  // addresses derived from it then live in uniform registers
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == 0) {  // the producer warpgroup; one thread issues every load
    hopper::regs_dec<F::kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::prefetch_map(&tq);
      hopper::prefetch_map(&tk);
      hopper::prefetch_map(&tv);
      int kt = 0, qi = 0;  // key tiles and query tiles loaded so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++qi) {
        const FwdTile ft = fwd_tile<kD>(p, t, bh, mt);
        if (qi > 0) hopper::mbar_wait(empty_q, (qi - 1) & 1);
        hopper::mbar_expect_tx(full_q, F::kQBytes);
#pragma unroll
        for (int b = 0; b < F::kBoxes; ++b)
          hopper::tma_load_4d(qs + b * F::kM * 64, &tq, full_q, 64 * b, ft.q0, ft.ih, ft.ib);
#pragma unroll 1
        for (int j = 0; j < ft.n; ++j, ++kt) {
          const int st = kt % kS;
          const uint32_t ph = (kt / kS) & 1;
          hopper::mbar_wait(&empty_k[st], ph ^ 1);
          hopper::mbar_expect_tx(&full_k[st], F::kKVBytes);
#pragma unroll
          for (int b = 0; b < F::kBoxes; ++b)
            hopper::tma_load_4d(ks + (st * F::kBoxes + b) * kN * 64, &tk, &full_k[st], 64 * b, j * kN, ft.ih, ft.ib);
          hopper::mbar_wait(&empty_v[st], ph ^ 1);
          hopper::mbar_expect_tx(&full_v[st], F::kKVBytes);
#pragma unroll
          for (int b = 0; b < F::kBoxes; ++b)
            hopper::tma_load_4d(vs + (st * F::kBoxes + b) * kN * 64, &tv, &full_v[st], 64 * b, j * kN, ft.ih, ft.ib);
        }
      }
    }
  } else {  // a consumer warpgroup
    hopper::regs_inc<F::kConsumerRegs>();
    const int wg = wgi - 1, tid = threadIdx.x & 127;
    const int g = (tid & 31) >> 2, t4 = tid & 3;
    const bf16* qw = qs + 64 * 64 * wg;
    const float c = p.scale * kLog2e;
    // ping-pong: a warpgroup issues its products in its turn (named
    // barrier 1 + wg, 256 threads: its own sync and the previous
    // warpgroup's arrive), then passes the turn on, so that one
    // warpgroup's softmax runs under the next one's products
    const auto turn_wait = [&] { hopper::bar_sync(1 + wg, 256); };
    const auto turn_pass = [&] { hopper::bar_arrive(1 + (wg + 1) % F::kWG, 256); };
    if (wg == 0) hopper::bar_arrive(1, 256);  // the first turn is warpgroup 0's

    int kt = 0, qi = 0;  // key tiles and query tiles consumed so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++qi) {
      const FwdTile ft = fwd_tile<kD>(p, t, bh, mt);
      const int n = ft.n;
      const int w0 = ft.q0 + 64 * wg, r0 = w0 + 16 * (tid >> 5) + g;  // this lane's rows r0, r0 + 8
      // tiles crossing the ragged edge or (causal) the diagonal of this
      // warpgroup's rows are masked; every other tile runs with no test
      const auto masked = [&](int k0) { return k0 + kN > p.sk || (p.causal && k0 + kN - 1 > w0); };
      float o[kD / 2];
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
      float s[kN / 2];
      uint32_t pa[kN / 16][4];
      float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f}, corr[2];

      hopper::mbar_wait(full_q, qi & 1);
      hopper::mbar_wait(&full_k[kt % kS], (kt / kS) & 1);
      turn_wait();
      issue_scores<kD>(s, qw, ks + (kt % kS) * kN * kD);
      turn_pass();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      if (tid == 0) {
        hopper::mbar_arrive(&empty_k[kt % kS]);
        if (n == 1) hopper::mbar_arrive(empty_q);  // the last score product of this Q is done
      }
      if (masked(0))
        softmax_rows<true, kN>(p, c, r0, 0, s, m, l, corr);
      else
        softmax_rows<false, kN>(p, c, r0, 0, s, m, l, corr);
      to_fragments<kN>(s, pa);
#pragma unroll 1
      for (int j = 1; j < n; ++j) {
        const int st = (kt + j) % kS, pst = (kt + j - 1) % kS;
        hopper::mbar_wait(&full_k[st], ((kt + j) / kS) & 1);
        turn_wait();
        issue_scores<kD>(s, qw, ks + st * kN * kD);  // S of key tile j ...
        hopper::mbar_wait(&full_v[pst], ((kt + j - 1) / kS) & 1);
        issue_pv<kD>(o, pa, vs + pst * kN * kD);  // ... under O += P V of key tile j - 1
        turn_pass();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);
        if (tid == 0) {
          hopper::mbar_arrive(&empty_k[st]);
          if (j == n - 1) hopper::mbar_arrive(empty_q);
        }
        const int k0 = j * kN;
        if (masked(k0))
          softmax_rows<true, kN>(p, c, r0, k0, s, m, l, corr);
        else
          softmax_rows<false, kN>(p, c, r0, k0, s, m, l, corr);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        if (tid == 0) hopper::mbar_arrive(&empty_v[pst]);
#pragma unroll
        for (int i = 0; i < kD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        to_fragments<kN>(s, pa);  // bf16(P) for O += P V; l summed the f32 P
      }
      const int lst = (kt + n - 1) % kS;
      hopper::mbar_wait(&full_v[lst], ((kt + n - 1) / kS) & 1);
      turn_wait();
      issue_pv<kD>(o, pa, vs + lst * kN * kD);
      turn_pass();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (tid == 0) hopper::mbar_arrive(&empty_v[lst]);
      kt += n;

      float lnz[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        lnz[i] = fmaxf(l[i], 1e-30f);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        store_row<kD>(p.out0 + (((int64_t)ft.ib * p.sq + row) * p.h + ft.ih) * p.d, o, half, 1.f / lnz[half], p.d,
                      row < p.sq);
        if (t4 == 0 && row < p.sq)
          p.lse_out[((int64_t)ft.ib * p.h + ft.ih) * p.sq + row] = (m[half] * c + log2f(lnz[half])) * kLn2;
      }
    }
  }
}

// SMs of the current device: the persistent grid's size
int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 1;
  }
  return count;
}

template <int kD>
int launch_fwd(const Params& p, int b, cudaStream_t stream) {
  using F = Fwd<kD>;
  CUtensorMap maps[3];
  const bf16* ptr[3] = {p.q, p.k, p.v};
  const int64_t st[3][3] = {{p.q_sb, p.q_ss, p.q_sh}, {p.k_sb, p.k_ss, p.k_sh}, {p.v_sb, p.v_ss, p.v_sh}};
  for (int i = 0; i < 3; ++i) {
    const int e = hopper::encode_bshd(&maps[i], ptr[i], b, i == 0 ? p.sq : p.sk, p.h, p.d, st[i][0], st[i][1],
                                      st[i][2], i == 0 ? F::kM : F::kN);
    if (e) return e;
  }
  const int bh = b * p.h, mt = (p.sq + F::kM - 1) / F::kM;
  const int grid = min(bh * mt, sm_count());  // persistent: one block an SM
  flash_fwd_bf16_wgmma_kernel<kD><<<grid, F::kThreads, F::kSmem, stream>>>(p, bh, mt, maps[0], maps[1], maps[2]);
  return (int)cudaGetLastError();
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
      scores<kD, fresh<kD>()>(qw, kt, s, gw, vt, dp, d);  // S = Q K^T, dP = dO V^T
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
    scores<kD, fresh<kD>()>(kw, qt, s, vw, gt, dp, d);  // S^T = K Q^T, dP^T = V dO^T
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

// the forward's body up to kStagedD (one per bucket fwd_dim) and its shared bytes
void* fwd_kernel_of(int d) {
  switch (fwd_dim(d)) {
    case 64: return (void*)flash_fwd_bf16_wgmma_kernel<64>;
    case 128: return (void*)flash_fwd_bf16_wgmma_kernel<128>;
    case 192: return (void*)flash_fwd_bf16_wgmma_kernel<192>;
    default: return (void*)flash_fwd_bf16_wgmma_kernel<256>;
  }
}

size_t fwd_smem(int d) {
  switch (fwd_dim(d)) {
    case 64: return Fwd<64>::kSmem;
    case 128: return Fwd<128>::kSmem;
    case 192: return Fwd<192>::kSmem;
    default: return Fwd<256>::kSmem;
  }
}

// bytes of dynamic shared memory of kernel `kind` at head_dim d; past
// kStagedD the ring, and the resident Q tile up to kWideResidentD
size_t smem_bytes(int kind, int d) {
  if (bucket(d) == 4) {
    const int dw = (d + 15) & ~15;
    return (dw <= kWideResidentD ? kWideStages * kRows * kWideLd + kWideQ * (dw + 8)
                                 : kWideStages * (kRows + kWideQ) * kWideLd) *
           sizeof(bf16);
  }
  if (kind == kFwd) return fwd_smem(d);
  const int kd = 32 << bucket(d);
  const size_t ld = kd + 8, st = kd <= 128 ? 2 : 1;
  if (kind == kDq) return (2 * kTile + 2 * st * kRows) * ld * sizeof(bf16);
  return (2 * kTile + 2 * st * kRows) * ld * sizeof(bf16) + 2 * st * kRows * sizeof(float);
}

void* kernel_of(int kind, int d) {
  if (kind == kFwd) return bucket(d) == 4 ? (void*)flash_fwd_wide_bf16_kernel : fwd_kernel_of(d);
  static void* const table[2][4] = {
      {(void*)flash_dq_bf16_kernel<32>, (void*)flash_dq_bf16_kernel<64>,
       (void*)flash_dq_bf16_kernel<128>, (void*)flash_dq_bf16_kernel<256>},
      {(void*)flash_dkv_bf16_kernel<32>, (void*)flash_dkv_bf16_kernel<64>,
       (void*)flash_dkv_bf16_kernel<128>, (void*)flash_dkv_bf16_kernel<256>}};
  return table[kind - 1][bucket(d)];
}

// the bucket a kernel is instantiated for: the forward's fwd_dim up to
// kStagedD, the backward's bucket(); 4 past kStagedD
int bucket_of(int kind, int d) {
  return bucket(d) == 4 || kind != kFwd ? bucket(d) : fwd_dim(d) / 64 - 1;
}

// Sets each kernel's shared-memory cap once: its size, or past kStagedD
// the largest of any head_dim (the resident Q tile at kWideResidentD).
int configure(int kind, int d) {
  static bool configured[3][5] = {};
  const int bi = bucket_of(kind, d);
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

// threads of a block of kernel `kind` at head_dim d: the forward's
// warpgroups up to kStagedD, else 16 query or key rows a warp
int threads_of(int kind, int d) {
  if (bucket(d) == 4) return kWideThreads;
  return kind == kFwd ? Fwd<64>::kThreads : kThreads;
}

int launch(int kind, const Params& p, int b, int rows, cudaStream_t stream) {
  if (!takes(kind, p.d)) return (int)cudaErrorInvalidValue;
  const int err = configure(kind, p.d);
  if (err) return err;
  if (kind == kFwd && bucket(p.d) != 4) {
    switch (fwd_dim(p.d)) {
      case 64: return launch_fwd<64>(p, b, stream);
      case 128: return launch_fwd<128>(p, b, stream);
      case 192: return launch_fwd<192>(p, b, stream);
      default: return launch_fwd<256>(p, b, stream);
    }
  }
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
