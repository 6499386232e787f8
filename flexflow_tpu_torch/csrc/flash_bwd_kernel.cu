// Flash attention backward for Hopper (sm_90a), fp32 in and out, products on
// the tensor cores in 3xTF32: the device body of kernels #2 and #3. Built by
// flexflow_tpu_torch/ops/cuda/_build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes by
// flexflow_tpu_torch/ops/cuda/flash_kernel.py. The helpers it shares with
// the forward (#1, csrc/flash_kernel.cu) are in csrc/flash_common.cuh.
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
// head_dim up to 256: kDT = 4, 8, 16 or 32 column tiles of 8. Past 128 a
// grid z index picks a chunk of at most 128 output columns: each block
// contracts S and dP over the whole head_dim and accumulates only its
// chunk of dQ (or of dK and dV), so a lane holds at most 2 x 16
// accumulator tiles, as at 128; the scores are recomputed once per chunk. There the two 64-row fixed tiles and one pair of loop tiles
// take 195 KB of shared memory, so the loop tiles are single-buffered.
// Past 256 (any multiple of 8) flash_dq_wide_kernel and
// flash_dkv_wide_kernel take the same chunks and stream the score
// contractions over head_dim in 128-column pieces (see them below).

#include "flash_common.cuh"

namespace {

using namespace flash;

// Loop tiles in flight: 2 (double-buffered) up to head_dim 128; 1 past it,
// where the fixed tiles (2 x 64 rows) and one loop tile pair at the
// stride of head_dim 256 already take 195 KB.
template <int kDT>
__host__ __device__ constexpr int stages() { return kDT <= 16 ? 2 : 1; }

// Score products with a fresh accumulator per k-step (product_nt) past
// head_dim 128, where a chain of 3 dt mma's into one accumulator drifts
// past the reference's scale; up to 128 (at most 48 mma's a chain) one
// accumulator a product stays within it and saves the adds.
template <int kDT>
__host__ __device__ constexpr bool fresh() { return kDT > 16; }

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

// -- dQ ------------------------------------------------------------------------------

// At most 170 registers where head_dim <= 64, so that 3 blocks share an SM;
// from head_dim 128 shared memory holds one block anyway.
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
  constexpr int kOT = out_tiles<kDT>(), kStages = stages<kDT>();
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // Q [64][ld]
  float* gs = qs + kTile * ld;                   // dO [64][ld]
  float* ks = gs + kTile * ld;                   // K [kStages][kLoop][ld]
  float* vs = ks + kStages * tile;               // V [kStages][kLoop][ld]
  const int d = p.d, dt = d / 8;
  int c0t, cn;  // this block's dQ columns: n-tiles [c0t, c0t + cn)
  out_chunk<kDT>(dt, c0t, cn);
  const int c0 = 8 * c0t;
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

  float acc[kOT][4], acc_odd[kOT][4];
  zero<kOT>(acc);
  zero<kOT>(acc_odd);
  const int k_end = p.causal ? min(p.sk, q0 + kTile) : p.sk;
  const int n = (k_end + kLoop - 1) / kLoop;
  const float* qw = qs + 16 * warp * ld;
  const float* gw = gs + 16 * warp * ld;
  for (int it = 0; it < n; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if (kStages == 2 && it + 1 < n) {
      const int nb = (it + 1) & 1;
      load_tile<kLoop>(ks + nb * tile, ld, kb, p.k_ss, (it + 1) * kLoop, p.sk, d);
      load_tile<kLoop>(vs + nb * tile, ld, vb, p.v_ss, (it + 1) * kLoop, p.sk, d);
      cp_async_commit();
    }
    const float* kt = ks + (kStages == 2 ? (it & 1) * tile : 0);
    const float* vt = vs + (kStages == 2 ? (it & 1) * tile : 0);
    float s[kNT][4], dp[kNT][4];
    zero<kNT>(s);
    zero<kNT>(dp);
    product_nt<kDT, kNT, fresh<kDT>()>(qw, kt, s, gw, vt, dp, dt);  // S = Q K^T, dP = dO V^T
    const int k0 = it * kLoop;
    const bool all = w0 + 16 <= p.sq && k0 + kLoop <= p.sk && (!p.causal || w0 >= k0 + kLoop - 1);
    if (all)
      ds_rows<false>(p, r0, k0, lse, dl, s, dp);
    else
      ds_rows<true>(p, r0, k0, lse, dl, s, dp);
    // dQ += dS K, the even and the odd 8-key steps into two accumulators
    product_pn<kDT, kNT / 2, 2, kOT>(dp, kt + c0, acc, dp + 1, kt + 8 * ld + c0, acc_odd, cn);
    if (kStages == 1 && it + 1 < n) {
      __syncthreads();  // every warp is done with tile it
      load_tile<kLoop>(ks, ld, kb, p.k_ss, (it + 1) * kLoop, p.sk, d);
      load_tile<kLoop>(vs, ld, vb, p.v_ss, (it + 1) * kLoop, p.sk, d);
      cp_async_commit();
    }
  }
#pragma unroll
  for (int j = 0; j < kOT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += acc_odd[j][e];
  store_rows<kOT>(p.out0 + c0, ib, ih, p.h, p.sq, r0, d, cn, acc);
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
  constexpr int kOT = out_tiles<kDT>(), kStages = stages<kDT>();
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // K [64][ld]
  float* vs = ks + kTile * ld;                   // V [64][ld]
  float* qs = vs + kTile * ld;                   // Q [kStages][kLoop][ld]
  float* gs = qs + kStages * tile;               // dO [kStages][kLoop][ld]
  float* ls = gs + kStages * tile;               // LSE [kStages][kLoop]
  float* dls = ls + kStages * kLoop;             // delta [kStages][kLoop]
  const int d = p.d, dt = d / 8;
  int c0t, cn;  // this block's dK and dV columns: n-tiles [c0t, c0t + cn)
  out_chunk<kDT>(dt, c0t, cn);
  const int c0 = 8 * c0t;
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
  float dk[kOT][4], dv[kOT][4];
  zero<kOT>(dk);
  zero<kOT>(dv);
  const float* kw = ks + 16 * warp * ld;
  const float* vw = vs + 16 * warp * ld;
  for (int it = 0; it < n; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if (kStages == 2 && it + 1 < n) {
      const int nb = (it + 1) & 1, q1 = q_start + (it + 1) * kLoop;
      load_tile<kLoop>(qs + nb * tile, ld, qb, p.q_ss, q1, p.sq, d);
      load_tile<kLoop>(gs + nb * tile, ld, gb, p.g_ss, q1, p.sq, d);
      load_rows(p, ib, ih, q1, ls + nb * kLoop, dls + nb * kLoop);
      cp_async_commit();
    }
    const int q0 = q_start + it * kLoop, cb = kStages == 2 ? it & 1 : 0;
    const float* qt = qs + cb * tile;
    const float* gt = gs + cb * tile;
    float s[kNT][4], dp[kNT][4];
    zero<kNT>(s);
    zero<kNT>(dp);
    product_nt<kDT, kNT, fresh<kDT>()>(kw, qt, s, vw, gt, dp, dt);  // S^T = K Q^T, dP^T = V dO^T
    const bool all = q0 + kLoop <= p.sq && w0 + 16 <= p.sk && (!p.causal || q0 >= w0 + 15);
    if (all)
      ds_cols<false>(p, r0, q0, ls + cb * kLoop, dls + cb * kLoop, s, dp);
    else
      ds_cols<true>(p, r0, q0, ls + cb * kLoop, dls + cb * kLoop, s, dp);
    // dV += P^T dO, dK += dS^T Q
    product_pn<kDT, kNT, 1, kOT>(s, gt + c0, dv, dp, qt + c0, dk, cn);
    if (kStages == 1 && it + 1 < n) {
      __syncthreads();  // every warp is done with tile it
      const int q1 = q_start + (it + 1) * kLoop;
      load_tile<kLoop>(qs, ld, qb, p.q_ss, q1, p.sq, d);
      load_tile<kLoop>(gs, ld, gb, p.g_ss, q1, p.sq, d);
      load_rows(p, ib, ih, q1, ls, dls);
      cp_async_commit();
    }
  }
  cp_async_wait_all();  // nothing in flight when the block exits
  store_rows<kOT>(p.out0 + c0, ib, ih, p.h, p.sk, r0, d, cn, dk);
  store_rows<kOT>(p.out1 + c0, ib, ih, p.h, p.sk, r0, d, cn, dv);
}

// -- head_dim past kStagedMaxD ---------------------------------------------------------
// The full-width tiles no longer fit shared memory, so for each loop tile
// the score contractions (S and dP) stream over head_dim: one
// kPieceTiles-wide piece of each of the four operands staged at a time,
// single-buffered, each piece's products added into S and dP with a fresh
// accumulator per k-step. The block's chunk (grid z, at most 128 columns)
// of the operand that the output product reads then takes the loop
// pieces' buffers. Shared memory stays at (2 x 64 + 2 x 32) rows of 132
// floats whatever head_dim is; the fixed operand is staged again for
// every loop tile.
// T = __nv_bfloat16 (mixed precision): the pieces are widened to fp32 as
// they are staged, every product takes one TF32 pass (exact on bf16
// values), P and dS are rounded to bf16 before the products that read them
// (the reference's casts, flash_kernel.py:260, :297, :306), and dQ, dK and
// dV are rounded to bf16 as they are stored; LSE and delta stay fp32.

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_wide_kernel(const Params p) {
  constexpr int kPT = kPieceTiles, ld = ld_of<kPT>(), tile = kLoop * ld;
  constexpr bool kOne = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // Q piece [64][ld]
  float* gs = qs + kTile * ld;                   // dO piece [64][ld]
  float* ks = gs + kTile * ld;                   // K piece, then K chunk [kLoop][ld]
  float* vs = ks + tile;                         // V piece [kLoop][ld]
  const int d = p.d, dt = d / 8, pieces = (dt + kPT - 1) / kPT;
  int c0t, cn;  // this block's dQ columns: n-tiles [c0t, c0t + cn)
  z_chunk(dt, c0t, cn);
  const int c0 = 8 * c0t;
  const int q0 = blockIdx.x * kTile, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const T* qb = reinterpret_cast<const T*>(p.q) + ib * p.q_sb + ih * p.q_sh;
  const T* gb = reinterpret_cast<const T*>(p.dout) + ib * p.g_sb + ih * p.g_sh;
  const T* kb = reinterpret_cast<const T*>(p.k) + ib * p.k_sb + ih * p.k_sh;
  const T* vb = reinterpret_cast<const T*>(p.v) + ib * p.v_sb + ih * p.v_sh;

  const int w0 = q0 + 16 * warp, r0 = w0 + g;
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const int64_t off = ((int64_t)ib * p.h + ih) * p.sq + r;
    lse[i] = r < p.sq ? p.lse[off] : 0.f;
    dl[i] = r < p.sq ? p.delta[off] : 0.f;
  }

  float acc[kPT][4], acc_odd[kPT][4];
  zero<kPT>(acc);
  zero<kPT>(acc_odd);
  const int k_end = p.causal ? min(p.sk, q0 + kTile) : p.sk;
  const int n = (k_end + kLoop - 1) / kLoop;
  const float* qw = qs + 16 * warp * ld;
  const float* gw = gs + 16 * warp * ld;
  for (int it = 0; it < n; ++it) {
    const int k0 = it * kLoop;
    float s[kNT][4], dp[kNT][4];
    zero<kNT>(s);
    zero<kNT>(dp);
    for (int pc = 0; pc < pieces; ++pc) {
      const int pt = min(kPT, dt - pc * kPT), col = 8 * kPT * pc;
      __syncthreads();  // every warp is done with the buffers
      stage_tile<kTile>(qs, ld, qb + col, p.q_ss, q0, p.sq, 8 * pt);
      stage_tile<kTile>(gs, ld, gb + col, p.g_ss, q0, p.sq, 8 * pt);
      stage_tile<kLoop>(ks, ld, kb + col, p.k_ss, k0, p.sk, 8 * pt);
      stage_tile<kLoop>(vs, ld, vb + col, p.v_ss, k0, p.sk, 8 * pt);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();  // the pieces are in
      product_nt<kPT, kNT, true, kOne>(qw, ks, s, gw, vs, dp, pt);  // S += Q K^T, dP += dO V^T
    }
    __syncthreads();  // every warp is done with the last K piece
    stage_tile<kLoop>(ks, ld, kb + c0, p.k_ss, k0, p.sk, 8 * cn);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // the K chunk is in
    const bool all = w0 + 16 <= p.sq && k0 + kLoop <= p.sk && (!p.causal || w0 >= k0 + kLoop - 1);
    if (all)
      ds_rows<false>(p, r0, k0, lse, dl, s, dp);
    else
      ds_rows<true>(p, r0, k0, lse, dl, s, dp);
    round_operands<T, kNT>(dp);
    // dQ += dS K, the even and the odd 8-key steps into two accumulators
    product_pn<kPT, kNT / 2, 2, kPT, kOne>(dp, ks, acc, dp + 1, ks + 8 * ld, acc_odd, cn);
  }
#pragma unroll
  for (int j = 0; j < kPT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += acc_odd[j][e];
  store_rows<kPT>(reinterpret_cast<T*>(p.out0) + c0, ib, ih, p.h, p.sq, r0, d, cn, acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_wide_kernel(const Params p) {
  constexpr int kPT = kPieceTiles, ld = ld_of<kPT>(), tile = kLoop * ld;
  constexpr bool kOne = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // K piece [64][ld]
  float* vs = ks + kTile * ld;                   // V piece [64][ld]
  float* qs = vs + kTile * ld;                   // Q piece, then Q chunk [kLoop][ld]
  float* gs = qs + tile;                         // dO piece, then dO chunk [kLoop][ld]
  float* ls = gs + tile;                         // LSE [kLoop]
  float* dls = ls + kLoop;                       // delta [kLoop]
  const int d = p.d, dt = d / 8, pieces = (dt + kPT - 1) / kPT;
  int c0t, cn;  // this block's dK and dV columns: n-tiles [c0t, c0t + cn)
  z_chunk(dt, c0t, cn);
  const int c0 = 8 * c0t;
  const int k0 = blockIdx.x * kTile, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const T* qb = reinterpret_cast<const T*>(p.q) + ib * p.q_sb + ih * p.q_sh;
  const T* gb = reinterpret_cast<const T*>(p.dout) + ib * p.g_sb + ih * p.g_sh;
  const T* kb = reinterpret_cast<const T*>(p.k) + ib * p.k_sb + ih * p.k_sh;
  const T* vb = reinterpret_cast<const T*>(p.v) + ib * p.v_sb + ih * p.v_sh;
  // causal: query tiles above the diagonal see none of these keys
  const int q_start = p.causal ? k0 : 0;
  const int n = p.sq > q_start ? (p.sq - q_start + kLoop - 1) / kLoop : 0;

  const int w0 = k0 + 16 * warp, r0 = w0 + g;  // this lane's keys r0, r0 + 8
  float dk[kPT][4], dv[kPT][4];
  zero<kPT>(dk);
  zero<kPT>(dv);
  const float* kw = ks + 16 * warp * ld;
  const float* vw = vs + 16 * warp * ld;
  for (int it = 0; it < n; ++it) {
    const int q0 = q_start + it * kLoop;
    float s[kNT][4], dp[kNT][4];
    zero<kNT>(s);
    zero<kNT>(dp);
    for (int pc = 0; pc < pieces; ++pc) {
      const int pt = min(kPT, dt - pc * kPT), col = 8 * kPT * pc;
      __syncthreads();  // every warp is done with the buffers
      stage_tile<kTile>(ks, ld, kb + col, p.k_ss, k0, p.sk, 8 * pt);
      stage_tile<kTile>(vs, ld, vb + col, p.v_ss, k0, p.sk, 8 * pt);
      stage_tile<kLoop>(qs, ld, qb + col, p.q_ss, q0, p.sq, 8 * pt);
      stage_tile<kLoop>(gs, ld, gb + col, p.g_ss, q0, p.sq, 8 * pt);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();  // the pieces are in
      product_nt<kPT, kNT, true, kOne>(kw, qs, s, vw, gs, dp, pt);  // S^T += K Q^T, dP^T += V dO^T
    }
    __syncthreads();  // every warp is done with the last Q and dO pieces
    stage_tile<kLoop>(qs, ld, qb + c0, p.q_ss, q0, p.sq, 8 * cn);
    stage_tile<kLoop>(gs, ld, gb + c0, p.g_ss, q0, p.sq, 8 * cn);
    load_rows(p, ib, ih, q0, ls, dls);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // the chunks and the rows are in
    const bool all = q0 + kLoop <= p.sq && w0 + 16 <= p.sk && (!p.causal || q0 >= w0 + 15);
    if (all)
      ds_cols<false>(p, r0, q0, ls, dls, s, dp);
    else
      ds_cols<true>(p, r0, q0, ls, dls, s, dp);
    round_operands<T, kNT>(s);
    round_operands<T, kNT>(dp);
    // dV += P^T dO, dK += dS^T Q
    product_pn<kPT, kNT, 1, kPT, kOne>(s, gs, dv, dp, qs, dk, cn);
  }
  store_rows<kPT>(reinterpret_cast<T*>(p.out0) + c0, ib, ih, p.h, p.sk, r0, d, cn, dk);
  store_rows<kPT>(reinterpret_cast<T*>(p.out1) + c0, ib, ih, p.h, p.sk, r0, d, cn, dv);
}

// -- launch ----------------------------------------------------------------------------

enum Kind { kDq = 0, kDkv = 1 };

// 2 staged tiles of 64 rows and 2 x kStages of kLoop rows at the bucket's
// stride (+ 2 x kStages LSE / delta rows for dK/dV); past kStagedMaxD 2
// pieces of 64 rows and 2 of kLoop rows (+ one LSE / delta row pair)
size_t smem_bytes(int kind, int d) {
  const bool wide = bucket(d) == 4;
  const int kdt = wide ? kPieceTiles : 4 << bucket(d), st = wide || kdt > 16 ? 1 : 2;
  const size_t rows = 2 * kTile + 2 * st * kLoop, ld = 8 * kdt + 4;
  return (rows * ld + (kind == kDq ? 0 : 2 * st * kLoop)) * sizeof(float);
}

void* kernel_of(int kind, int d) {
  static void* const table[2][5] = {
      {(void*)flash_dq_mma_kernel<4>, (void*)flash_dq_mma_kernel<8>,
       (void*)flash_dq_mma_kernel<16>, (void*)flash_dq_mma_kernel<32>,
       (void*)flash_dq_wide_kernel<float>},
      {(void*)flash_dkv_mma_kernel<4>, (void*)flash_dkv_mma_kernel<8>,
       (void*)flash_dkv_mma_kernel<16>, (void*)flash_dkv_mma_kernel<32>,
       (void*)flash_dkv_wide_kernel<float>}};
  return table[kind][bucket(d)];
}

int configure(int kind, int d) {
  static bool configured[2][5] = {};
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
  dim3 grid((rows + kTile - 1) / kTile, b * p.h, chunks(p.d));
  void* args[] = {(void*)&p};
  cudaError_t e = cudaLaunchKernel(kernel_of(kind, p.d), grid, dim3(kThreads), args,
                                   smem_bytes(kind, p.d), stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The bf16 wide kernels (head_dim past kStagedMaxD only; csrc/
// flash_bf16_kernel.cu's bodies take bf16 up to it).
int launch_wide_bf16(int kind, const Params& p, int b, int rows, cudaStream_t stream) {
  if (!takes(p.d) || bucket(p.d) != 4) return (int)cudaErrorInvalidValue;
  static bool configured[2] = {};
  void* fn = kind == kDq ? (void*)flash_dq_wide_kernel<__nv_bfloat16> : (void*)flash_dkv_wide_kernel<__nv_bfloat16>;
  if (!configured[kind]) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(kind, p.d));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured[kind] = true;
  }
  dim3 grid((rows + kTile - 1) / kTile, b * p.h, chunks(p.d));
  void* args[] = {(void*)&p};
  cudaError_t e = cudaLaunchKernel(fn, grid, dim3(kThreads), args, smem_bytes(kind, p.d), stream);
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
  const int err = configure(kind, d);
  if (err) return err;
  return flash::occupancy(kernel_of(kind, d), smem_bytes(kind, d), out);
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

// As ff_flash_dq_f32 for bf16 q, k, v, dO (rows 16-byte aligned) and dQ
// at head_dim past 256 (any multiple of 8); lse and delta fp32.
int ff_flash_dq_wide_bf16(const void* q, const void* k, const void* v,
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
  return launch_wide_bf16(kDq, p, b, sq, (cudaStream_t)stream);
}

// As ff_flash_dq_wide_bf16, writing dk and dv (bf16) contiguous [b, sk, h, d].
int ff_flash_dkv_wide_bf16(const void* q, const void* k, const void* v,
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
  return launch_wide_bf16(kDkv, p, b, sk, (cudaStream_t)stream);
}

}  // extern "C"
