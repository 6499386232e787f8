// Flash attention forward and backward for Hopper (sm_90a) on bf16 operands:
// the device bodies of kernels #1, #2 and #3 under mixed precision. Built by
// flexflow_tpu_torch/ops/cuda/_build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes by
// flexflow_tpu_torch/ops/cuda/flash_kernel.py. The fp32 bodies are
// csrc/flash_kernel.cu (#1) and csrc/flash_bwd_kernel.cu (#2, #3; its wide
// kernels also take #2 and #3 at bf16 past head_dim 256). #1, #2 and #3 up
// to head_dim 256 are built from csrc/hopper.cuh (TMA, mbarriers, wgmma);
// #1 past 256 shares the fp32 bodies' cp.async staging
// (csrc/flash_common.cuh).
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
//   * flash_dq_bf16_wgmma_kernel replaces _dq_kernel (:230, pallas_call
//     :384): P = exp(S - LSE), dP = dO V^T in f32, dS = P (dP - delta)
//     scale rounded to bf16 (:260), dQ = dS K in f32, rounded to bf16;
//   * flash_dkv_bf16_wgmma_kernel replaces _dkv_kernel (:269, pallas_call :419):
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
// #2 and #3 up to head_dim 256 (flash_dq_bf16_wgmma_kernel<kD> and
// flash_dkv_bf16_wgmma_kernel<kD>, #1's buckets). What bounds them on this
// card at the flagship shape: 7 products of 4.29 GFLOP (S and dP in both
// kernels, dQ = dS K, dK = dS^T Q, dV = P^T dO), 30.1 GFLOP, 0.0304 ms at
// 989 TFLOP/s; a kernel that folded dQ into #3 (FA2/FA3's layout) would
// do 5, but only with f32 atomics whose order changes the bits from call
// to call, which this port does not take (two calls give the same bits).
// No [b, h, s, s] tensor is written. The bodies they replaced (mma.sync
// m16n8k16, 4 warps over a 64-row fixed tile, cp.async behind a barrier a
// tile) took 0.2395 ms together, 2.6x cuDNN's backward; what this design
// does about each cause (measured on an H100 at [8, 512, 16, 64],
// scripts/flash_bwd_bf16_variants.py):
//   * mma.sync's rate, every B fragment a thread's own load: every product
//     is wgmma m64nNk16 issued by a warpgroup. #2, per consumer warpgroup
//     of 64 query rows: S = Q K^T and dP = dO V^T read Q, dO and the K and
//     V stage through descriptors (SS, K-major); dS is rounded to bf16 and
//     packed into A fragments where it stands, and dQ += dS K reads K
//     MN-major (RS, N = kD), as #1's P V reads V. #3, per warpgroup of 64
//     keys: S^T = K Q^T and dP^T = V dO^T (SS), P^T and dS^T in registers,
//     dV += bf16(P^T) dO and dK += bf16(dS^T) Q (RS, dO and Q MN-major).
//     A TMA box reads both ways (hopper.cuh), so one staged copy of each
//     operand serves both of its products.
//   * each staged byte feeding 64 rows: a producer warpgroup (one thread,
//     24 registers) loads the fixed tile once a work tile (Q and dO for
//     #2, K and V for #3, 128 rows) and the loop tiles into a ring of
//     kStages stages with full and empty mbarriers (#2: K and V apart, V
//     freed once dP is done; #3: Q, dO and the tile's LSE and delta
//     together, the two read flat); two consumer warpgroups (240 registers
//     each) share every loop tile, so each staged byte feeds 128 rows.
//   * a synchronous loop: the ring keeps TMA loads in flight under the
//     products (3 stages up to head_dim 128: with 2, #2 took 14-18% longer
//     at head_dim 64 and 31% at 128, #3 1-8%; 4 were within 4% either
//     way); the consumer warpgroups issue their products in turns on named
//     barriers (ping-pong: #2 5% slower without it, #3 within 2%); #2
//     issues key tile j's S and dP with tile j - 1's dS K and computes dS
//     under that product (7-9% faster), where #3 issues each tile's
//     products apart (issuing them together measured 7% slower there).
//   * exponentials in base 2 with the scale folded in (ex2.approx of c s -
//     L, c = scale log2(e), L = LSE log2(e)), as #1's; without them the
//     kernels took 6-7% less time.
//   * the replaced bodies' 1024 blocks at 2 an SM: the grid is persistent,
//     one block an SM walking the 512 work tiles (one block a tile: 14-16%
//     slower), longest first when causal (#2 the last query tiles, #3 the
//     first key tiles); causal loop tiles past the diagonal are never
//     loaded, and #3's key tiles no query sees store zeros without a load.
//     Tiles crossing sq, sk or (causal) the diagonal of a warpgroup's rows
//     test one limit per entry; all others none.
//   * registers: #2 holds dQ (kD / 2 f32 a thread), S and dP (kN / 2 each)
//     and the dS fragments; kN, the keys of a loop tile, is 128 at
//     head_dim 64 (64 measured 10-12% slower) and 64 past it. #3 holds dK and
//     dV (kC / 2 each), S^T and dP^T at kM = 64 queries a tile and two
//     fragment sets; kC, a work tile's output columns, is kD up to 128,
//     and past it the grid also walks output chunks (64 columns at 192,
//     128 at 256), the scores recomputed per chunk. 0 spill bytes in every
//     bucket. At 256 the resident tile (Q and dO, or K and V) takes 128 KB,
//     so one stage there.
//   * dP's accuracy: from head_dim 128 dP is one fresh chain per 64-column
//     box, added in f32 (issue_score_pair says why and what was measured).
// #2 and #3 past head_dim 256 are refused here (takes(); the wrapper sends
// them to flash_bwd_kernel.cu's wide kernels).
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
using flash::z_chunk;

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;         // key rows of a loop tile of #1 past kStagedD
constexpr int kSN = kRows / 8;    // 8-wide n-tiles of a warp's 16 x kRows scores
constexpr int kStagedD = 256;     // widest head_dim of the wgmma bodies
constexpr int kFwdOT = 16;        // output n-tiles of one block of #1 past kStagedD
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

// grid z: output-column chunks of at most max_tiles n-tiles
int chunks(int d, int max_tiles) { return (d / 8 + max_tiles - 1) / max_tiles; }

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

// -- staging ----------------------------------------------------------------------------

// Rows [row0, row0 + kN) of one head of a [b, s, h, d] bf16 tensor (base
// already at the batch, head and first column) into dst [kN][ld]: `width`
// columns in 16-byte pieces, of which those at or past `cols` and the rows
// at or past `rows` are zero-filled; by the block's kNThreads threads.
template <int kN, int kNThreads>
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
__host__ __device__ __forceinline__ int width16(int d) { return (d + 15) & ~15; }

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

// Query tile t of the (b h) x (query tiles of F::kM rows) of #1 or #2
// (F: Fwd or Dq), the last query tiles (the longest when causal) first:
// batch ib, head ih, first row q0, and n, the key tiles of F::kN rows it
// reads.
struct FwdTile {
  int ib, ih, q0, n;
};

template <class F>
__device__ __forceinline__ FwdTile query_tile(const Params& p, int t, int bh, int mt) {
  FwdTile r;
  r.ib = (t % bh) / p.h;
  r.ih = t % p.h;
  r.q0 = (mt - 1 - t / bh) * F::kM;
  const int k_end = p.causal ? min(p.sk, r.q0 + F::kM) : p.sk;
  r.n = (k_end + F::kN - 1) / F::kN;
  return r;
}

// #1 at head_dim up to 256 (the header's design). Block b takes query
// tiles b, b + gridDim.x, ... (query_tile) of the bh x mt. Warpgroup 0 is
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
        const FwdTile ft = query_tile<F>(p, t, bh, mt);
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
      const FwdTile ft = query_tile<F>(p, t, bh, mt);
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

// -- #2 and #3 up to head_dim 256: wgmma over TMA-fed tiles --------------------------------

// Shape of #2's block at head_dim bucket kD (the header says why each
// number): two consumer warpgroups of 64 query rows share every K and V
// tile; Q and dO stay resident for the block's query tile.
template <int kD>
struct Dq {
  static constexpr int kWG = 2;                        // consumer warpgroups, 64 query rows each
  static constexpr int kM = 64 * kWG;                  // query rows of a block
  static constexpr int kN = kD <= 64 ? 128 : 64;       // key rows of a loop tile
  static constexpr int kStages = kD <= 128 ? 3 : kD <= 192 ? 2 : 1;  // K and V tiles in flight
  static constexpr bool kOverlap = kStages > 1;        // S and dP of tile j under dS K of tile j - 1
  static constexpr int kBoxes = kD / 64;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr uint32_t kQBytes = kM * kD * 2, kKVBytes = kN * kD * 2;
  static constexpr int kBars = 2 + 4 * kStages;        // full and empty for Q + dO, and for K and V per stage
  static constexpr size_t kSmem = 1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 8 * kBars;
};

// Shape of #3's block: two consumer warpgroups of 64 keys share every Q,
// dO, LSE and delta tile; K and V stay resident for the block's key tile.
// kC output columns of dK and dV a work tile (all of kD up to 128; past
// it grid chunks, the scores recomputed per chunk).
template <int kD>
struct Dkv {
  static constexpr int kWG = 2;                        // consumer warpgroups, 64 keys each
  static constexpr int kN = 64 * kWG;                  // keys of a block
  static constexpr int kM = 64;                        // query rows of a loop tile
  static constexpr int kC = kD <= 128 ? kD : kD == 192 ? 64 : 128;
  static constexpr int kChunks = kD / kC;
  static constexpr int kStages = kD <= 128 ? 3 : kD <= 192 ? 2 : 1;  // Q, dO, LSE and delta tiles in flight
  static constexpr int kBoxes = kD / 64;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  // LSE and delta boxes start on 16 bytes (a box whose first element is
  // not 16-byte aligned faults), so each takes kM + 4 values from the
  // multiple of 4 at or below the tile's first row, into slots of kRowSlot
  static constexpr int kRowBox = kM + 4, kRowSlot = kM + 32;
  static constexpr uint32_t kKVBytes = kN * kD * 2, kQBytes = kM * kD * 2, kRowBytes = kRowBox * 4;
  static constexpr int kBars = 2 + 2 * kStages;        // full and empty for K + V, and for each Q stage
  static constexpr size_t kSmem =
      1024 + 2 * kKVBytes + kStages * (2 * kQBytes + 2 * kRowSlot * 4) + 8 * kBars;
};

// s = A B^T and s2 = A2 B2^T over kD head_dim columns: the warpgroup's 64
// rows of A, A2 (boxes of kARows rows, already at the warpgroup's first
// row) against the kBRows rows of B, B2, all K-major. s2 (dP) is kD / 64
// chains, one a 64-column box, each into a fresh accumulator and added in
// f32 (s the temporary, each box past the first waited for); s is issued
// last, the commit group the caller waits for. The tensor cores truncate
// the sum of every k16 step of a
// chain; where one key is visible dP - delta is nothing but that error:
// measured on an H100 (sk = 1), one chain of 8 steps (head_dim 128) left
// dK at 3.0x the plain version's error and one of 13-16 (200-256) dQ
// and dK at 3.5-5.2x, over the float64 gate, where a 4-step chain
// (head_dim 64) stays at 1.2-2.0x.
template <int kD, int kARows, int kBRows>
__device__ __forceinline__ void issue_score_pair(float (&s)[kBRows / 2], float (&s2)[kBRows / 2], const bf16* a,
                                                 const bf16* b, const bf16* a2, const bf16* b2) {
#pragma unroll
  for (int x = 0; x < kD / 64; ++x) {
    float(&acc)[kBRows / 2] = x == 0 ? s2 : s;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaSS<kBRows, 0, 0>::run(acc, hopper::desc_kmajor(a2 + x * kARows * 64 + 16 * kk),
                                         hopper::desc_kmajor(b2 + x * kBRows * 64 + 16 * kk), kk > 0);
    hopper::wgmma_commit();
    if (x > 0) {
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(s2);
#pragma unroll
      for (int i = 0; i < kBRows / 2; ++i) s2[i] += s[i];
    }
  }
  hopper::fence_regs(s);
  hopper::fence_regs(s2);
  hopper::wgmma_fence();
#pragma unroll
  for (int x = 0; x < kD / 64; ++x)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaSS<kBRows, 0, 0>::run(s, hopper::desc_kmajor(a + x * kARows * 64 + 16 * kk),
                                         hopper::desc_kmajor(b + x * kBRows * 64 + 16 * kk), x + kk > 0);
  hopper::wgmma_commit();
  hopper::fence_regs(s);
}

// acc += A B over the kK rows of one tile (A the bf16 fragments a, kK / 16
// k16 steps), B MN-major in boxes of kK rows x 64 columns, b at the box of
// the first output column; N = kNOut. Issued inside the caller's fences.
template <int kNOut, int kK>
__device__ __forceinline__ void issue_rs(float (&acc)[kNOut / 2], uint32_t (&a)[kK / 16][4], const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk)
    hopper::WgmmaRS<kNOut, 1>::run(acc, a[kk], hopper::desc_mnmajor(b + 16 * 64 * kk, kK * 128), 1);
}

// dS of the warpgroup's scores in place of dP (the accumulator layout:
// rows r0, r0 + 8, keys k0 + 8j + 2t (+1)): P = 2^(c s - L), c = scale
// log2(e) and L the row's LSE log2(e); dS = P (dP - delta) scale in f32,
// 0 where masked (kMasked: key 8j + (e & 1) of row i is visible below
// lim[i], which counts from k0 + 2t).
template <bool kMasked, int kN>
__device__ __forceinline__ void ds_rows(float c, float scale, const int lim[2], const float L[2], const float dl[2],
                                        const float (&s)[kN / 2], float (&dp)[kN / 2]) {
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const bool ok = !kMasked || 8 * j + (e & 1) < lim[i];
      const float pr = ok ? ex2(fmaf(s[4 * j + e], c, -L[i])) : 0.f;
      dp[4 * j + e] = pr * (dp[4 * j + e] - dl[i]) * scale;
    }
}

// P^T and dS^T of the warpgroup's keys (rows r0, r0 + 8) x the tile's kM
// queries (columns 8j + 2t (+1)) in place of S^T and dP^T; lt and dlt the
// tile's LSE and delta in shared memory. kMasked: column 8j + (e & 1) is
// visible below hi and at or past lo[i] (both counted from q0 + 2t).
template <bool kMasked, int kM>
__device__ __forceinline__ void ds_cols(float c, float scale, int hi, const int lo[2], const float* lt,
                                        const float* dlt, float (&s)[kM / 2], float (&dp)[kM / 2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kM / 8; ++j) {
    const float* l2 = lt + 8 * j + 2 * t;
    const float* d2 = dlt + 8 * j + 2 * t;
    const float L[2] = {l2[0] * kLog2e, l2[1] * kLog2e}, dl[2] = {d2[0], d2[1]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + (e & 1);
      const bool ok = !kMasked || (col < hi && col >= lo[e >> 1]);
      const float pr = ok ? ex2(fmaf(s[4 * j + e], c, -L[e & 1])) : 0.f;
      s[4 * j + e] = pr;
      dp[4 * j + e] = pr * (dp[4 * j + e] - dl[e & 1]) * scale;
    }
  }
}

// #2 at head_dim up to 256 (the header's design). Block b takes query
// tiles b, b + gridDim.x, ... (query_tile: the last, the longest when
// causal, first). Warpgroup 0 is the producer: one thread loads each
// tile's Q and dO once, then K and V tiles of kN keys into a ring of
// kStages stages with full and empty mbarriers (V is freed when dP is
// done, K when dS K is). Warpgroups 1 .. kWG each own 64 query rows: S = Q
// K^T and dP = dO V^T (SS), dS in registers, dQ += bf16(dS) K (RS, K
// MN-major); the next key tile's S and dP are issued with this one's dS K.
template <int kD>
__global__ void __launch_bounds__(Dq<kD>::kThreads, 1)
    flash_dq_bf16_wgmma_kernel(const Params p, int bh, int mt, const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tg) {
  using F = Dq<kD>;
  constexpr int kN = F::kN, kS = F::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(base);  // Q [kBoxes][kM][64]
  bf16* gs = qs + F::kM * kD;                 // dO [kBoxes][kM][64]
  bf16* ks = gs + F::kM * kD;                 // K [kS][kBoxes][kN][64]
  bf16* vs = ks + kS * kN * kD;               // V [kS][kBoxes][kN][64]
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

  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == 0) {  // the producer warpgroup; one thread issues every load
    hopper::regs_dec<F::kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::prefetch_map(&tq);
      hopper::prefetch_map(&tk);
      hopper::prefetch_map(&tv);
      hopper::prefetch_map(&tg);
      int kt = 0, qi = 0;  // key tiles and query tiles loaded so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++qi) {
        const FwdTile ft = query_tile<F>(p, t, bh, mt);
        if (qi > 0) hopper::mbar_wait(empty_q, (qi - 1) & 1);
        hopper::mbar_expect_tx(full_q, 2 * F::kQBytes);
#pragma unroll
        for (int b = 0; b < F::kBoxes; ++b) {
          hopper::tma_load_4d(qs + b * F::kM * 64, &tq, full_q, 64 * b, ft.q0, ft.ih, ft.ib);
          hopper::tma_load_4d(gs + b * F::kM * 64, &tg, full_q, 64 * b, ft.q0, ft.ih, ft.ib);
        }
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
    const bf16* gw = gs + 64 * 64 * wg;
    const float c = p.scale * kLog2e;
    // ping-pong, as the forward's
    const auto turn_wait = [&] { hopper::bar_sync(1 + wg, 256); };
    const auto turn_pass = [&] { hopper::bar_arrive(1 + (wg + 1) % F::kWG, 256); };
    if (wg == 0) hopper::bar_arrive(1, 256);

    int kt = 0, qi = 0;  // key tiles and query tiles consumed so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++qi) {
      const FwdTile ft = query_tile<F>(p, t, bh, mt);
      const int n = ft.n;
      const int w0 = ft.q0 + 64 * wg, r0 = w0 + 16 * (tid >> 5) + g;  // this lane's rows r0, r0 + 8
      float L[2], dl[2];  // the rows' LSE log2(e) and delta (0 past sq: those rows are never stored)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const int64_t off = ((int64_t)ft.ib * p.h + ft.ih) * p.sq + r;
        L[i] = r < p.sq ? p.lse[off] * kLog2e : 0.f;
        dl[i] = r < p.sq ? p.delta[off] : 0.f;
      }
      const auto masked = [&](int k0) { return k0 + kN > p.sk || (p.causal && k0 + kN - 1 > w0); };
      const auto ds = [&](int k0, const float(&s)[kN / 2], float(&dp)[kN / 2]) {
        int lim[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) lim[i] = (p.causal ? min(p.sk, r0 + 8 * i + 1) : p.sk) - k0 - 2 * t4;
        if (masked(k0))
          ds_rows<true, kN>(c, p.scale, lim, L, dl, s, dp);
        else
          ds_rows<false, kN>(c, p.scale, lim, L, dl, s, dp);
      };
      float dq[kD / 2];
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;
      float s[kN / 2], dp[kN / 2];
      uint32_t da[kN / 16][4];
      const auto issue_dq = [&](int st) {  // dQ += bf16(dS) K of stage st
        hopper::fence_regs(dq);
        hopper::fence_regs(da);
        hopper::wgmma_fence();
        issue_rs<kD, kN>(dq, da, ks + st * kN * kD);
        hopper::wgmma_commit();
        hopper::fence_regs(dq);
      };

      // S and dP of key tile j, then dS in registers (V is free once dP is done)
      const auto scores = [&](int j, bool overlap) {
        const int st = (kt + j) % kS;
        const uint32_t ph = ((kt + j) / kS) & 1;
        hopper::mbar_wait(&full_k[st], ph);
        hopper::mbar_wait(&full_v[st], ph);
        turn_wait();
        issue_score_pair<kD, F::kM, kN>(s, dp, qw, ks + st * kN * kD, gw, vs + st * kN * kD);
        if (overlap) issue_dq((kt + j - 1) % kS);  // ... under dQ += dS K of key tile j - 1
        turn_pass();
      };
      const auto release_sdp = [&](int j) {
        if (tid == 0) {
          hopper::mbar_arrive(&empty_v[(kt + j) % kS]);
          if (j == n - 1) hopper::mbar_arrive(empty_q);  // the last product of this Q and dO is done
        }
      };
      const auto finish_dq = [&](int j) {  // dQ += dS K of key tile j, alone
        turn_wait();
        issue_dq((kt + j) % kS);
        turn_pass();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dq);
        if (tid == 0) hopper::mbar_arrive(&empty_k[(kt + j) % kS]);
      };

      hopper::mbar_wait(full_q, qi & 1);
      if constexpr (F::kOverlap) {
        scores(0, false);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        release_sdp(0);
        ds(0, s, dp);
        to_fragments<kN>(dp, da);  // bf16(dS)
#pragma unroll 1
        for (int j = 1; j < n; ++j) {
          scores(j, true);
          hopper::wgmma_wait<1>();
          hopper::fence_regs(s);
          hopper::fence_regs(dp);
          release_sdp(j);
          ds(j * kN, s, dp);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dq);
          if (tid == 0) hopper::mbar_arrive(&empty_k[(kt + j - 1) % kS]);
          to_fragments<kN>(dp, da);
        }
        finish_dq(n - 1);
      } else {
#pragma unroll 1
        for (int j = 0; j < n; ++j) {
          scores(j, false);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(s);
          hopper::fence_regs(dp);
          release_sdp(j);
          ds(j * kN, s, dp);
          to_fragments<kN>(dp, da);
          finish_dq(j);
        }
      }
      kt += n;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        store_row<kD>(p.out0 + (((int64_t)ft.ib * p.sq + row) * p.h + ft.ih) * p.d, dq, half, 1.f, p.d,
                      row < p.sq);
      }
    }
  }
}

// Key tile t of #3's chunks x (b h) x (key tiles of kN rows), the first
// key tiles (the longest when causal) first: batch ib, head ih, first key
// k0, output chunk ch, the first query q0 any of its keys sees and n, the
// query tiles of kM rows from there (0 when causal and sq <= k0).
struct KeyTile {
  int ib, ih, k0, ch, q0, n;
};

template <int kD>
__device__ __forceinline__ KeyTile key_tile(const Params& p, int t, int bh) {
  using F = Dkv<kD>;
  KeyTile r;
  r.ch = t % F::kChunks;
  const int rest = t / F::kChunks;
  r.ib = (rest % bh) / p.h;
  r.ih = rest % p.h;
  r.k0 = rest / bh * F::kN;
  r.q0 = p.causal ? r.k0 : 0;  // causal: queries above the block's first key see none of it
  r.n = p.sq > r.q0 ? (p.sq - r.q0 + F::kM - 1) / F::kM : 0;
  return r;
}

// #3 at head_dim up to 256 (the header's design). Block b takes key tiles
// b, b + gridDim.x, ... (key_tile). Warpgroup 0 is the producer: one
// thread loads each tile's K and V once, then Q, dO, LSE and delta tiles
// of kM queries into a ring of kStages stages. Warpgroups 1 .. kWG each
// own 64 keys: S^T = K Q^T and dP^T = V dO^T (SS), P^T and dS^T in
// registers, dV += bf16(P^T) dO and dK += bf16(dS^T) Q (RS, dO and Q
// MN-major), the chunk's kC output columns of each.
template <int kD>
__global__ void __launch_bounds__(Dkv<kD>::kThreads, 1)
    flash_dkv_bf16_wgmma_kernel(const Params p, int bh, int tiles, const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tg, const __grid_constant__ CUtensorMap tl,
                                const __grid_constant__ CUtensorMap tdl) {
  using F = Dkv<kD>;
  constexpr int kM = F::kM, kS = F::kStages, kC = F::kC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* ks = reinterpret_cast<bf16*>(base);  // K [kBoxes][kN][64]
  bf16* vs = ks + F::kN * kD;                 // V [kBoxes][kN][64]
  bf16* qs = vs + F::kN * kD;                 // Q [kS][kBoxes][kM][64]
  bf16* gs = qs + kS * kM * kD;               // dO [kS][kBoxes][kM][64]
  float* ls = reinterpret_cast<float*>(gs + kS * kM * kD);  // LSE [kS][kRowSlot]
  float* dls = ls + kS * F::kRowSlot;                       // delta [kS][kRowSlot]
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(dls + kS * F::kRowSlot);
  uint64_t* empty_kv = full_kv + 1;
  uint64_t* full_q = empty_kv + 1;
  uint64_t* empty_q = full_q + kS;
  if (threadIdx.x == 0) {
    hopper::mbar_init(full_kv, 1);
    hopper::mbar_init(empty_kv, F::kWG);
    for (int i = 0; i < kS; ++i) {
      hopper::mbar_init(&full_q[i], 1);
      hopper::mbar_init(&empty_q[i], F::kWG);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == 0) {  // the producer warpgroup; one thread issues every load
    hopper::regs_dec<F::kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::prefetch_map(&tq);
      hopper::prefetch_map(&tk);
      hopper::prefetch_map(&tv);
      hopper::prefetch_map(&tg);
      hopper::prefetch_map(&tl);
      hopper::prefetch_map(&tdl);
      int qt = 0, kvi = 0;  // query tiles and K/V tiles loaded so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const KeyTile kt = key_tile<kD>(p, t, bh);
        if (kt.n == 0) continue;  // no query sees these keys: nothing to load
        if (kvi > 0) hopper::mbar_wait(empty_kv, (kvi - 1) & 1);
        ++kvi;
        hopper::mbar_expect_tx(full_kv, 2 * F::kKVBytes);
#pragma unroll
        for (int b = 0; b < F::kBoxes; ++b) {
          hopper::tma_load_4d(ks + b * F::kN * 64, &tk, full_kv, 64 * b, kt.k0, kt.ih, kt.ib);
          hopper::tma_load_4d(vs + b * F::kN * 64, &tv, full_kv, 64 * b, kt.k0, kt.ih, kt.ib);
        }
        const int row0 = (kt.ib * p.h + kt.ih) * p.sq + kt.q0;  // the tile's first LSE and delta
#pragma unroll 1
        for (int j = 0; j < kt.n; ++j, ++qt) {
          const int st = qt % kS;
          hopper::mbar_wait(&empty_q[st], ((qt / kS) & 1) ^ 1);
          hopper::mbar_expect_tx(&full_q[st], 2 * F::kQBytes + 2 * F::kRowBytes);
#pragma unroll
          for (int b = 0; b < F::kBoxes; ++b) {
            hopper::tma_load_4d(qs + (st * F::kBoxes + b) * kM * 64, &tq, &full_q[st], 64 * b, kt.q0 + j * kM, kt.ih,
                                kt.ib);
            hopper::tma_load_4d(gs + (st * F::kBoxes + b) * kM * 64, &tg, &full_q[st], 64 * b, kt.q0 + j * kM, kt.ih,
                                kt.ib);
          }
          const int r = (row0 + j * kM) & ~3;  // the box's 16-byte-aligned start
          hopper::tma_load_1d(ls + st * F::kRowSlot, &tl, &full_q[st], r);
          hopper::tma_load_1d(dls + st * F::kRowSlot, &tdl, &full_q[st], r);
        }
      }
    }
  } else {  // a consumer warpgroup
    hopper::regs_inc<F::kConsumerRegs>();
    const int wg = wgi - 1, tid = threadIdx.x & 127;
    const int g = (tid & 31) >> 2, t4 = tid & 3;
    const bf16* kw = ks + 64 * 64 * wg;
    const bf16* vw = vs + 64 * 64 * wg;
    const float c = p.scale * kLog2e;
    const auto turn_wait = [&] { hopper::bar_sync(1 + wg, 256); };
    const auto turn_pass = [&] { hopper::bar_arrive(1 + (wg + 1) % F::kWG, 256); };
    if (wg == 0) hopper::bar_arrive(1, 256);

    int qt = 0, kvi = 0;  // query tiles and K/V tiles consumed so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const KeyTile kt = key_tile<kD>(p, t, bh);
      const int n = kt.n, c0 = kt.ch * kC;
      const int w0 = kt.k0 + 64 * wg, r0 = w0 + 16 * (tid >> 5) + g;  // this lane's keys r0, r0 + 8
      float dk[kC / 2], dv[kC / 2];
#pragma unroll
      for (int i = 0; i < kC / 2; ++i) dk[i] = dv[i] = 0.f;
      // query tiles crossing sq or (causal) the diagonal of this
      // warpgroup's keys are masked; every other tile runs with no test
      const int o = ((kt.ib * p.h + kt.ih) * p.sq + kt.q0) & 3;  // the first row's place in its LSE box
      const auto ds = [&](int j, int st, float(&s)[kM / 2], float(&dp)[kM / 2]) {
        const int q0 = kt.q0 + j * kM;
        const int hi = p.sq - q0 - 2 * t4;
        const int lo[2] = {p.causal ? r0 - q0 - 2 * t4 : -kM, p.causal ? r0 + 8 - q0 - 2 * t4 : -kM};
        const float* lt = ls + st * F::kRowSlot + o;
        const float* dlt = dls + st * F::kRowSlot + o;
        if (q0 + kM > p.sq || (p.causal && q0 < w0 + 63))
          ds_cols<true, kM>(c, p.scale, hi, lo, lt, dlt, s, dp);
        else
          ds_cols<false, kM>(c, p.scale, hi, lo, lt, dlt, s, dp);
      };
      float s[kM / 2], dp[kM / 2];
      uint32_t pa[kM / 16][4], da[kM / 16][4];
      const auto issue_dkv = [&](int st) {  // dV += bf16(P^T) dO and dK += bf16(dS^T) Q of stage st
        hopper::fence_regs(dv);
        hopper::fence_regs(dk);
        hopper::fence_regs(pa);
        hopper::fence_regs(da);
        hopper::wgmma_fence();
        const int col = (c0 / 64) * kM * 64;  // the chunk's first box
        issue_rs<kC, kM>(dv, pa, gs + st * kM * kD + col);
        issue_rs<kC, kM>(dk, da, qs + st * kM * kD + col);
        hopper::wgmma_commit();
        hopper::fence_regs(dv);
        hopper::fence_regs(dk);
      };
      if (n > 0) {
        hopper::mbar_wait(full_kv, kvi & 1);
        ++kvi;
      }
#pragma unroll 1
      for (int j = 0; j < n; ++j) {
        const int st = (qt + j) % kS;
        hopper::mbar_wait(&full_q[st], ((qt + j) / kS) & 1);
        turn_wait();
        issue_score_pair<kD, F::kN, kM>(s, dp, kw, qs + st * kM * kD, vw, gs + st * kM * kD);
        turn_pass();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        if (tid == 0 && j == n - 1) hopper::mbar_arrive(empty_kv);  // the last product of this K and V is done
        ds(j, st, s, dp);
        to_fragments<kM>(s, pa);   // bf16(P^T)
        to_fragments<kM>(dp, da);  // bf16(dS^T)
        turn_wait();
        issue_dkv(st);
        turn_pass();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dv);
        hopper::fence_regs(dk);
        if (tid == 0) hopper::mbar_arrive(&empty_q[st]);
      }
      qt += n;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        const int64_t off = (((int64_t)kt.ib * p.sk + row) * p.h + kt.ih) * p.d + c0;
        store_row<kC>(p.out0 + off, dk, half, 1.f, p.d - c0, row < p.sk);
        store_row<kC>(p.out1 + off, dv, half, 1.f, p.d - c0, row < p.sk);
      }
    }
  }
}

// -- launch ----------------------------------------------------------------------------------

// The body of kernel `kind` at head_dim d: the wgmma bodies at the bucket
// fwd_dim(d) up to kStagedD, the forward's wide body past it.
void* kernel_of(int kind, int d) {
  if (d > kStagedD) return (void*)flash_fwd_wide_bf16_kernel;
  static void* const table[3][4] = {
      {(void*)flash_fwd_bf16_wgmma_kernel<64>, (void*)flash_fwd_bf16_wgmma_kernel<128>,
       (void*)flash_fwd_bf16_wgmma_kernel<192>, (void*)flash_fwd_bf16_wgmma_kernel<256>},
      {(void*)flash_dq_bf16_wgmma_kernel<64>, (void*)flash_dq_bf16_wgmma_kernel<128>,
       (void*)flash_dq_bf16_wgmma_kernel<192>, (void*)flash_dq_bf16_wgmma_kernel<256>},
      {(void*)flash_dkv_bf16_wgmma_kernel<64>, (void*)flash_dkv_bf16_wgmma_kernel<128>,
       (void*)flash_dkv_bf16_wgmma_kernel<192>, (void*)flash_dkv_bf16_wgmma_kernel<256>}};
  return table[kind][fwd_dim(d) / 64 - 1];
}

template <template <int> class F>
size_t smem_of(int d) {
  switch (fwd_dim(d)) {
    case 64: return F<64>::kSmem;
    case 128: return F<128>::kSmem;
    case 192: return F<192>::kSmem;
    default: return F<256>::kSmem;
  }
}

// bytes of dynamic shared memory of kernel `kind` at head_dim d; past
// kStagedD the ring, and the resident Q tile up to kWideResidentD
size_t smem_bytes(int kind, int d) {
  if (d > kStagedD) {
    const int dw = width16(d);
    return (dw <= kWideResidentD ? kWideStages * kRows * kWideLd + kWideQ * (dw + 8)
                                 : kWideStages * (kRows + kWideQ) * kWideLd) *
           sizeof(bf16);
  }
  return kind == kFwd ? smem_of<Fwd>(d) : kind == kDq ? smem_of<Dq>(d) : smem_of<Dkv>(d);
}

// the instantiation a head_dim runs: 0-3 the bucket fwd_dim, 4 past kStagedD
int bucket_of(int d) { return d > kStagedD ? 4 : fwd_dim(d) / 64 - 1; }

// Sets each kernel's shared-memory cap once: its size, or past kStagedD
// the largest of any head_dim (the resident Q tile at kWideResidentD).
int configure(int kind, int d) {
  static bool configured[3][5] = {};
  const int bi = bucket_of(d);
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

// threads of a block of kernel `kind` at head_dim d: a producer and two
// consumer warpgroups up to kStagedD, the wide forward's warps past it
int threads_of(int d) { return d > kStagedD ? kWideThreads : Fwd<64>::kThreads; }

// Tensor maps of q, k, v and (count 4) dO: boxes of q_rows rows of q and
// dO, kv_rows rows of k and v.
int encode_operands(const Params& p, int b, int q_rows, int kv_rows, int count, CUtensorMap* maps) {
  const bf16* ptr[4] = {p.q, p.k, p.v, p.dout};
  const int64_t st[4][3] = {
      {p.q_sb, p.q_ss, p.q_sh}, {p.k_sb, p.k_ss, p.k_sh}, {p.v_sb, p.v_ss, p.v_sh}, {p.g_sb, p.g_ss, p.g_sh}};
  for (int i = 0; i < count; ++i) {
    const bool rows_q = i == 0 || i == 3;
    const int e = hopper::encode_bshd(&maps[i], ptr[i], b, rows_q ? p.sq : p.sk, p.h, p.d, st[i][0], st[i][1],
                                      st[i][2], rows_q ? q_rows : kv_rows);
    if (e) return e;
  }
  return 0;
}

template <int kD>
int launch_fwd(const Params& p, int b, cudaStream_t stream) {
  using F = Fwd<kD>;
  CUtensorMap maps[3];
  const int e = encode_operands(p, b, F::kM, F::kN, 3, maps);
  if (e) return e;
  const int bh = b * p.h, mt = (p.sq + F::kM - 1) / F::kM;
  const int grid = min(bh * mt, sm_count());  // persistent: one block an SM
  flash_fwd_bf16_wgmma_kernel<kD><<<grid, F::kThreads, F::kSmem, stream>>>(p, bh, mt, maps[0], maps[1], maps[2]);
  return (int)cudaGetLastError();
}

template <int kD>
int launch_dq(const Params& p, int b, cudaStream_t stream) {
  using F = Dq<kD>;
  CUtensorMap maps[4];
  const int e = encode_operands(p, b, F::kM, F::kN, 4, maps);
  if (e) return e;
  const int bh = b * p.h, mt = (p.sq + F::kM - 1) / F::kM;
  const int grid = min(bh * mt, sm_count());
  flash_dq_bf16_wgmma_kernel<kD><<<grid, F::kThreads, F::kSmem, stream>>>(p, bh, mt, maps[0], maps[1], maps[2],
                                                                         maps[3]);
  return (int)cudaGetLastError();
}

template <int kD>
int launch_dkv(const Params& p, int b, cudaStream_t stream) {
  using F = Dkv<kD>;
  CUtensorMap maps[6];
  int e = encode_operands(p, b, F::kM, F::kN, 4, maps);
  const int64_t rows = (int64_t)b * p.h * p.sq;  // LSE and delta, read flat
  if (!e) e = hopper::encode_flat_f32(&maps[4], p.lse, rows, F::kRowBox);
  if (!e) e = hopper::encode_flat_f32(&maps[5], p.delta, rows, F::kRowBox);
  if (e) return e;
  const int bh = b * p.h, tiles = bh * ((p.sk + F::kN - 1) / F::kN) * F::kChunks;
  const int grid = min(tiles, sm_count());
  flash_dkv_bf16_wgmma_kernel<kD><<<grid, F::kThreads, F::kSmem, stream>>>(p, bh, tiles, maps[0], maps[1],
                                                                          maps[2], maps[3], maps[4], maps[5]);
  return (int)cudaGetLastError();
}

int launch(int kind, const Params& p, int b, int rows, cudaStream_t stream) {
  if (!takes(kind, p.d)) return (int)cudaErrorInvalidValue;
  const int err = configure(kind, p.d);
  if (err) return err;
  if (p.d <= kStagedD) {
    switch (4 * kind + fwd_dim(p.d) / 64 - 1) {
      case 0: return launch_fwd<64>(p, b, stream);
      case 1: return launch_fwd<128>(p, b, stream);
      case 2: return launch_fwd<192>(p, b, stream);
      case 3: return launch_fwd<256>(p, b, stream);
      case 4: return launch_dq<64>(p, b, stream);
      case 5: return launch_dq<128>(p, b, stream);
      case 6: return launch_dq<192>(p, b, stream);
      case 7: return launch_dq<256>(p, b, stream);
      case 8: return launch_dkv<64>(p, b, stream);
      case 9: return launch_dkv<128>(p, b, stream);
      case 10: return launch_dkv<192>(p, b, stream);
      default: return launch_dkv<256>(p, b, stream);
    }
  }
  // #1 past kStagedD: query tiles of kWideQ rows x (b h) x output chunks
  dim3 grid((rows + kWideQ - 1) / kWideQ, b * p.h, chunks(p.d, kFwdOT));
  void* args[] = {(void*)&p};
  cudaError_t e = cudaLaunchKernel((void*)flash_fwd_wide_bf16_kernel, grid, dim3(kWideThreads), args,
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
  return flash::occupancy(kernel_of(kind, d), smem_bytes(kind, d), out, threads_of(d));
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
