// Flash attention backward for Hopper (sm_90a), fp32 in and out, products on
// the tensor cores in 3xTF32: the device body of kernels #2 and #3. Built by
// flexflow_tpu_torch/ops/cuda/_build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes by
// flexflow_tpu_torch/ops/cuda/flash_kernel.py.
//
// What it replaces: two Pallas TPU kernels of
// flexflow_tpu/ops/pallas/flash_kernel.py —
//   * flash_dq_mma_kernel replaces _dq_kernel (:230, pallas_call :384):
//     dQ = sum over key tiles of dS K, dS = P * (dO V^T - delta) * scale,
//     P = exp(Q K^T * scale - LSE);
//   * flash_dkv_mma_kernel replaces _dkv_kernel (:269, pallas_call :419):
//     dV = sum over query tiles of P^T dO and dK = dS^T Q.
// As on the TPU the backward is two kernels, one accumulating over key tiles
// and one over query tiles, so no two blocks write the same output row: no
// atomics, and the gradients are bit-identical from run to run.
//
// What bounds it: operations. At the flagship shape (b 8, s 512, h 16, d 64)
// the pair does 7 products of depth 64 over 33.5 M (query, key) pairs, 30
// GFLOP, against 184 MB of operands and outputs: 163 flops a byte, past the
// card's balance at any of its fp32-accurate rates. fp32 FMAs (67 TFLOP/s)
// are not the fastest such rate: the TF32 tensor cores run 495 TFLOP/s
// dense, and three TF32 passes per product keep fp32 accuracy (3xTF32, as
// CUTLASS's OpMultiplyAddFastF32 with its default rounding): each operand
// x is split into big = x with the 13 low mantissa bits cleared and
// small = tf32_rna(x - big), and
// a b ~ small_a big_b + big_a small_b + big_a big_b, small terms first,
// accumulated in fp32 (error ~2^-21 per product; one TF32 pass alone is
// ~2^-11). The design:
//   * mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 as inline PTX.
//     (wgmma on .tf32 wants both operands K-major, and P^T dO and dS^T Q
//     contract over the row index of a row-major tile, so it would need
//     transposed staging.)
//   * The split takes 3 integer and float instructions per value (see
//     split()): it is the largest share of the instructions a product
//     issues, and cvt.rna.tf32.f32 compiles to a longer sequence with a
//     NaN test (4 instructions where 1 or 2 do).
//   * A block of 4 warps owns one 64-row tile of its fixed operand (queries
//     for dQ, keys for dK/dV) and loops over the other operand's 32-row
//     tiles; each warp owns 16 rows. Scores, P and dS live in m16n8
//     accumulator fragments in registers, where the scale, the mask,
//     exp(s - lse) and p (dp - delta) scale are applied.
//   * What holds it on this card is the latency of chains of dependent
//     mma instructions, not the rate at which the tensor cores take them
//     (scripts/mma_tf32_rate.py measures that rate): each 3xTF32 product
//     is 3 mma's into one accumulator. So every loop runs two independent
//     products side by side (S with dP, dV with dK, and dQ's even and odd
//     8-key steps into two accumulators), and the 32-row loop tiles keep a
//     block at 70 KB of shared memory and at most 170 registers, so that 3
//     blocks (12 warps) share an SM at head_dim <= 64 (1 at head_dim 128,
//     whose tiles take 135 KB).
//   * dK/dV computes the transposed scores S^T = K Q^T, so an accumulator
//     row is one of the warp's own keys. An accumulator fragment feeds the
//     next product (dS K, P^T dO, dS^T Q) as its A operand directly: a
//     lane holds columns 2t and 2t + 1 of each 8-wide tile, which are the A
//     fragment's columns t and t + 4 once the k index inside a k-step is
//     permuted (slot t -> 2t, slot t + 4 -> 2t + 1), and the B operand's
//     contraction rows are read in the same order. No shared-memory round
//     trip and no block-wide barrier between the products.
//   * Every operand tile is staged once, row-major, with a row stride of
//     ld = 8 kDT + 4 floats (the bucket's largest head_dim + 4, so every
//     shared-memory offset is a compile-time constant). Both fragment
//     reads are then free of bank conflicts: row g, column t (A of every
//     product, B of the score products: bank g ld + t, and ld / 4 is odd)
//     and row 2t, column g (B of the products that contract over a tile's
//     rows: bank 2t ld + g).
//   * A warp whose 16 x 32 tile of scores is all visible (no ragged edge,
//     wholly below the causal diagonal) skips the mask tests.
//   * The next loop tile is loaded with cp.async into a second buffer while
//     the current tile's products run: one __syncthreads per tile, none
//     between the products.
//   * Masked and padded entries weigh exactly 0 whatever the LSE is; rows
//     past sq or sk are zero-filled by the copies and never stored. The
//     causal mask is qpos >= kpos from a shared origin (also when
//     sq != sk); the dQ loop stops at the diagonal key tile and the dK/dV
//     loop starts at the diagonal query tile.
//   * [b, s, h, d] operands are read in place through their strides;
//     LSE and delta are [b, h, sq] rows.
// head_dim is a multiple of 8 up to 128: kDT = 4, 8 or 16 column tiles of 8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // rows of the fixed operand's tile
constexpr int kLoop = 32;     // rows of the loop operand's tile
constexpr int kWarps = 4;     // 16 rows of the fixed tile each
constexpr int kThreads = 32 * kWarps;

// Row stride of a staged tile for head_dims of the kDT bucket.
template <int kDT>
__host__ __device__ constexpr int ld_of() { return 8 * kDT + 4; }

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;   // dO [b, sq, h, d]
  const float* lse;    // [b, h, sq]
  const float* delta;  // [b, h, sq], rowsum(dO * O) - g_lse
  float* out0;         // dQ, or dK (contiguous [b, s, h, d])
  float* out1;         // dV
  int h, sq, sk, d;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t g_sb, g_ss, g_sh;
  float scale;
  int causal;
};

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

// c += a b in 3xTF32, the small terms first; a is already split (it is
// reused across a k-step's n-tiles), b is split here.
__device__ __forceinline__ void mma3(float c[4], const uint32_t ab[4],
                                     const uint32_t as[4], const float b[2]) {
  uint32_t bb[2], bs[2];
  split(b[0], bb[0], bs[0]);
  split(b[1], bb[1], bs[1]);
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// -- products of one warp -------------------------------------------------------
// Lane l is (g, t) = (l / 4, l % 4). An m16n8 accumulator c[4] holds rows g
// (c[0], c[1]) and g + 8 (c[2], c[3]) at columns 2t and 2t + 1.

// acc0[j] += A0 B0_j^T and acc1[j] += A1 B1_j^T, the two products taken
// together so that 2 kNT accumulators are in flight: A0, A1 are 16 rows and
// B0, B1 8 kNT rows, all row-major with head_dim contiguous (stride ld);
// the contraction runs over head_dim. Reads: A[g][c], B[8j + g][c] with
// c = 8 ks + t (+4).
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
        const float b0[2] = {B0[8 * j * ld + c], B0[8 * j * ld + c + 4]};
        const float b1[2] = {B1[8 * j * ld + c], B1[8 * j * ld + c + 4]};
        mma3(acc0[j], ab0, as0, b0);
        mma3(acc1[j], ab1, as1, b1);
      }
    }
  }
}

// acc0[j] += P0 B0[:, 8j : 8j + 8] and acc1[j] += P1 B1[:, 8j : 8j + 8],
// two products taken together as in product_nt. P0, P1 are 16 x 8 kKT, the
// accumulator fragments of an earlier product, read at every kS-th n-tile
// (P[kS kk]); B0, B1 are row-major (stride ld), read at rows 8 kS kk + 0..7
// for head_dim columns 8j..8j + 7. The contraction runs over P's columns =
// B's rows, visited inside each k-step in the order 0, 2, 4, 6, 1, 3, 5, 7,
// so that P's fragment is the A operand as it stands. Reads:
// B[8 kS kk + 2t (+1)][8j + g].
template <int kDT, int kKT, int kS>
__device__ __forceinline__ void product_pn(const float P0[][4], const float* B0,
                                           float acc0[kDT][4], const float P1[][4],
                                           const float* B1, float acc1[kDT][4],
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
    for (int j = 0; j < kDT; ++j) {
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

// Rows [row0, row0 + kRows) of one head of a [b, s, h, d] tensor (base
// already at the batch and head) into dst [kRows][ld]; rows at or past
// `rows` are zero. Neighbouring threads copy neighbouring 16-byte pieces
// of a row.
template <int kRows>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* base,
                                          int64_t s_stride, int row0, int rows,
                                          int d) {
  const int d4 = d / 4;
  for (int i = threadIdx.x; i < kRows * d4; i += kThreads) {
    const int r = i / d4, c4 = i - r * d4;
    const bool in = row0 + r < rows;
    cp_async(dst + r * ld + 4 * c4, base + (int64_t)(in ? row0 + r : 0) * s_stride + 4 * c4, 16, in);
  }
}

// LSE and delta of queries [q0, q0 + kLoop) into ls, dls (0 past sq).
__device__ __forceinline__ void load_rows(const Params& p, int ib, int ih, int q0,
                                          float* ls, float* dls) {
  if (threadIdx.x >= 2 * kLoop) return;
  const int r = threadIdx.x % kLoop;
  const bool in = q0 + r < p.sq;
  const int64_t off = ((int64_t)ib * p.h + ih) * p.sq + (in ? q0 + r : 0);
  if (threadIdx.x < kLoop)
    cp_async(ls + r, p.lse + off, 4, in);
  else
    cp_async(dls + r, p.delta + off, 4, in);
}

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  return qi < p.sq && kj < p.sk && (!p.causal || qi >= kj);
}

// Rows r0 (acc[j][0..1]) and r0 + 8 (acc[j][2..3]) of a contiguous
// [b, s, h, d] output; rows at or past s are skipped.
template <int kDT>
__device__ __forceinline__ void store_rows(float* out, int ib, int ih, int h,
                                           int s, int r0, int d, int dt,
                                           const float acc[kDT][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= s) continue;
    float* o = out + (((int64_t)ib * s + row) * h + ih) * d + 2 * t;
#pragma unroll
    for (int j = 0; j < kDT; ++j)
      if (j < dt)
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

// -- dQ ------------------------------------------------------------------------------

constexpr int kNT = kLoop / 8;  // 8-wide n-tiles of one loop tile's scores

// At most 170 registers where head_dim <= 64, so that 3 blocks share an SM;
// at head_dim 128 shared memory holds one block anyway.
__host__ __device__ constexpr int min_blocks(int kDT) { return kDT <= 8 ? 3 : 1; }

// dS of the warp's 16 x kLoop scores in place of dP: p = exp(s scale - lse),
// ds = p (dp - delta) scale, 0 where masked (kMasked) for rows r0, r0 + 8
// and keys k0 + 8j + 2t (+1).
template <bool kMasked>
__device__ __forceinline__ void ds_rows(const Params& p, int r0, int k0,
                                        const float lse[2], const float dl[2],
                                        const float s[kNT][4], float dp[kNT][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const bool ok = !kMasked || visible(p, r0 + 8 * i, k0 + 8 * j + 2 * t + (e & 1));
      const float pr = ok ? expf(s[j][e] * p.scale - lse[i]) : 0.f;
      dp[j][e] = pr * (dp[j][e] - dl[i]) * p.scale;
    }
}

template <int kDT>
__global__ void __launch_bounds__(kThreads, min_blocks(kDT)) flash_dq_mma_kernel(const Params p) {
  constexpr int ld = ld_of<kDT>(), tile = kLoop * ld;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // Q [64][ld]
  float* gs = qs + kTile * ld;                   // dO [64][ld]
  float* ks = gs + kTile * ld;                   // K [2][kLoop][ld]
  float* vs = ks + 2 * tile;                     // V [2][kLoop][ld]
  const int d = p.d, dt = d / 8;
  const int q0 = blockIdx.x * kTile, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const float* kb = p.k + ib * p.k_sb + ih * p.k_sh;
  const float* vb = p.v + ib * p.v_sb + ih * p.v_sh;
  load_tile<kTile>(qs, ld, p.q + ib * p.q_sb + ih * p.q_sh, p.q_ss, q0, p.sq, d);
  load_tile<kTile>(gs, ld, p.dout + ib * p.g_sb + ih * p.g_sh, p.g_ss, q0, p.sq, d);
  load_tile<kLoop>(ks, ld, kb, p.k_ss, 0, p.sk, d);
  load_tile<kLoop>(vs, ld, vb, p.v_ss, 0, p.sk, d);
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

  float acc[kDT][4], acc_odd[kDT][4];
  zero<kDT>(acc);
  zero<kDT>(acc_odd);
  const int k_end = p.causal ? min(p.sk, q0 + kTile) : p.sk;
  const int n = (k_end + kLoop - 1) / kLoop;
  const float* qw = qs + 16 * warp * ld;
  const float* gw = gs + 16 * warp * ld;
  for (int it = 0; it < n; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if (it + 1 < n) {
      const int nb = (it + 1) & 1;
      load_tile<kLoop>(ks + nb * tile, ld, kb, p.k_ss, (it + 1) * kLoop, p.sk, d);
      load_tile<kLoop>(vs + nb * tile, ld, vb, p.v_ss, (it + 1) * kLoop, p.sk, d);
      cp_async_commit();
    }
    const float* kt = ks + (it & 1) * tile;
    const float* vt = vs + (it & 1) * tile;
    float s[kNT][4], dp[kNT][4];
    zero<kNT>(s);
    zero<kNT>(dp);
    product_nt<kDT, kNT>(qw, kt, s, gw, vt, dp, dt);  // S = Q K^T, dP = dO V^T
    const int k0 = it * kLoop;
    const bool all = w0 + 16 <= p.sq && k0 + kLoop <= p.sk && (!p.causal || w0 >= k0 + kLoop - 1);
    if (all)
      ds_rows<false>(p, r0, k0, lse, dl, s, dp);
    else
      ds_rows<true>(p, r0, k0, lse, dl, s, dp);
    // dQ += dS K, the even and the odd 8-key steps into two accumulators
    product_pn<kDT, kNT / 2, 2>(dp, kt, acc, dp + 1, kt + 8 * ld, acc_odd, dt);
  }
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += acc_odd[j][e];
  store_rows<kDT>(p.out0, ib, ih, p.h, p.sq, r0, d, dt, acc);
}

// -- dK, dV ---------------------------------------------------------------------------

// P^T and dS^T of the warp's 16 keys x kLoop queries in place of S^T and
// dP^T, for keys r0, r0 + 8 and the tile's query columns 8j + 2t (+1),
// whose LSE and delta are lt, dlt.
template <bool kMasked>
__device__ __forceinline__ void ds_cols(const Params& p, int r0, int q0,
                                        const float* lt, const float* dlt,
                                        float s[kNT][4], float dp[kNT][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1);
      const bool ok = !kMasked || visible(p, q0 + col, r0 + 8 * (e >> 1));
      const float pr = ok ? expf(s[j][e] * p.scale - lt[col]) : 0.f;
      s[j][e] = pr;                                    // P^T
      dp[j][e] = pr * (dp[j][e] - dlt[col]) * p.scale;  // dS^T
    }
}

template <int kDT>
__global__ void __launch_bounds__(kThreads, min_blocks(kDT)) flash_dkv_mma_kernel(const Params p) {
  constexpr int ld = ld_of<kDT>(), tile = kLoop * ld;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // K [64][ld]
  float* vs = ks + kTile * ld;                   // V [64][ld]
  float* qs = vs + kTile * ld;                   // Q [2][kLoop][ld]
  float* gs = qs + 2 * tile;                     // dO [2][kLoop][ld]
  float* ls = gs + 2 * tile;                     // LSE [2][kLoop]
  float* dls = ls + 2 * kLoop;                   // delta [2][kLoop]
  const int d = p.d, dt = d / 8;
  const int k0 = blockIdx.x * kTile, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const float* qb = p.q + ib * p.q_sb + ih * p.q_sh;
  const float* gb = p.dout + ib * p.g_sb + ih * p.g_sh;
  // causal: query tiles above the diagonal see none of these keys
  const int q_start = p.causal ? k0 : 0;
  const int n = p.sq > q_start ? (p.sq - q_start + kLoop - 1) / kLoop : 0;
  load_tile<kTile>(ks, ld, p.k + ib * p.k_sb + ih * p.k_sh, p.k_ss, k0, p.sk, d);
  load_tile<kTile>(vs, ld, p.v + ib * p.v_sb + ih * p.v_sh, p.v_ss, k0, p.sk, d);
  if (n > 0) {
    load_tile<kLoop>(qs, ld, qb, p.q_ss, q_start, p.sq, d);
    load_tile<kLoop>(gs, ld, gb, p.g_ss, q_start, p.sq, d);
    load_rows(p, ib, ih, q_start, ls, dls);
  }
  cp_async_commit();

  const int w0 = k0 + 16 * warp, r0 = w0 + g;  // this lane's keys r0, r0 + 8
  float dk[kDT][4], dv[kDT][4];
  zero<kDT>(dk);
  zero<kDT>(dv);
  const float* kw = ks + 16 * warp * ld;
  const float* vw = vs + 16 * warp * ld;
  for (int it = 0; it < n; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if (it + 1 < n) {
      const int nb = (it + 1) & 1, q1 = q_start + (it + 1) * kLoop;
      load_tile<kLoop>(qs + nb * tile, ld, qb, p.q_ss, q1, p.sq, d);
      load_tile<kLoop>(gs + nb * tile, ld, gb, p.g_ss, q1, p.sq, d);
      load_rows(p, ib, ih, q1, ls + nb * kLoop, dls + nb * kLoop);
      cp_async_commit();
    }
    const int q0 = q_start + it * kLoop;
    const float* qt = qs + (it & 1) * tile;
    const float* gt = gs + (it & 1) * tile;
    float s[kNT][4], dp[kNT][4];
    zero<kNT>(s);
    zero<kNT>(dp);
    product_nt<kDT, kNT>(kw, qt, s, vw, gt, dp, dt);  // S^T = K Q^T, dP^T = V dO^T
    const bool all = q0 + kLoop <= p.sq && w0 + 16 <= p.sk && (!p.causal || q0 >= w0 + 15);
    if (all)
      ds_cols<false>(p, r0, q0, ls + (it & 1) * kLoop, dls + (it & 1) * kLoop, s, dp);
    else
      ds_cols<true>(p, r0, q0, ls + (it & 1) * kLoop, dls + (it & 1) * kLoop, s, dp);
    product_pn<kDT, kNT, 1>(s, gt, dv, dp, qt, dk, dt);  // dV += P^T dO, dK += dS^T Q
  }
  cp_async_wait_all();  // nothing in flight when the block exits
  store_rows<kDT>(p.out0, ib, ih, p.h, p.sk, r0, d, dt, dk);
  store_rows<kDT>(p.out1, ib, ih, p.h, p.sk, r0, d, dt, dv);
}

// -- launch ----------------------------------------------------------------------------

enum Kind { kDq = 0, kDkv = 1 };

// head_dim bucket: 8-column tiles kDT = 4, 8 or 16
int bucket(int d) { return d <= 32 ? 0 : d <= 64 ? 1 : 2; }

// 2 staged tiles of 64 rows and 2 x 2 of kLoop rows at the bucket's stride
// (+ 2 x 2 LSE / delta rows for dK/dV)
size_t smem_bytes(int kind, int d) {
  const size_t rows = 2 * kTile + 4 * kLoop, ld = (32 << bucket(d)) + 4;
  return (rows * ld + (kind == kDq ? 0 : 4 * kLoop)) * sizeof(float);
}

void* kernel_of(int kind, int d) {
  static void* const table[2][3] = {
      {(void*)flash_dq_mma_kernel<4>, (void*)flash_dq_mma_kernel<8>,
       (void*)flash_dq_mma_kernel<16>},
      {(void*)flash_dkv_mma_kernel<4>, (void*)flash_dkv_mma_kernel<8>,
       (void*)flash_dkv_mma_kernel<16>}};
  return table[kind][bucket(d)];
}

bool takes(int d) { return d > 0 && d <= 128 && d % 8 == 0; }

int configure(int kind, int d) {
  static bool configured[2][3] = {};
  const int bi = bucket(d);
  if (configured[kind][bi]) return 0;
  void* fn = kernel_of(kind, d);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes(kind, d));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  configured[kind][bi] = true;
  return 0;
}

int launch(int kind, const Params& p, int b, int rows, cudaStream_t stream) {
  if (!takes(p.d)) return (int)cudaErrorInvalidValue;
  const int err = configure(kind, p.d);
  if (err) return err;
  dim3 grid((rows + kTile - 1) / kTile, b * p.h);
  void* args[] = {(void*)&p};
  cudaError_t e = cudaLaunchKernel(kernel_of(kind, p.d), grid, dim3(kThreads), args,
                                   smem_bytes(kind, p.d), stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ff_flash_bwd_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// What one block of kernel `kind` (0 dQ, 1 dK/dV) at head_dim d takes and
// how many fit an SM: out = {registers per thread, local (spill) bytes per
// thread, dynamic shared bytes, threads, blocks per SM}.
int ff_flash_bwd_occupancy(int kind, int d, int* out) {
  if ((kind != kDq && kind != kDkv) || !takes(d)) return (int)cudaErrorInvalidValue;
  int err = configure(kind, d);
  if (err) return err;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel_of(kind, d));
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_of(kind, d), kThreads,
                                                      smem_bytes(kind, d));
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem_bytes(kind, d);
  out[3] = kThreads;
  out[4] = blocks;
  return 0;
}

// q [b, sq, h, d], k/v [b, sk, h, d], dO [b, sq, h, d] fp32 with head_dim
// contiguous and 16-byte aligned rows (strides *_sb, *_ss, *_sh in
// elements); lse and delta contiguous [b, h, sq]; dq contiguous
// [b, sq, h, d]. Returns cudaGetLastError() after the launch.
int ff_flash_dq_f32(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int b, int h, int sq, int sk, int d,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long g_sb, long long g_ss, long long g_sh,
                    float scale, int causal, void* stream) {
  Params p{(const float*)q, (const float*)k, (const float*)v,
           (const float*)dout, (const float*)lse, (const float*)delta,
           (float*)dq, nullptr, h, sq, sk, d,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           g_sb, g_ss, g_sh, scale, causal};
  return launch(kDq, p, b, sq, (cudaStream_t)stream);
}

// As ff_flash_dq_f32, writing dk and dv contiguous [b, sk, h, d].
int ff_flash_dkv_f32(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int b, int h, int sq, int sk, int d,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long g_sb, long long g_ss, long long g_sh,
                     float scale, int causal, void* stream) {
  Params p{(const float*)q, (const float*)k, (const float*)v,
           (const float*)dout, (const float*)lse, (const float*)delta,
           (float*)dk, (float*)dv, h, sq, sk, d,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           g_sb, g_ss, g_sh, scale, causal};
  return launch(kDkv, p, b, sk, (cudaStream_t)stream);
}

}  // extern "C"
