// Flash attention forward for Hopper (sm_90a), fp32 in and out, products on
// the tensor cores in 3xTF32: the device body of kernel #1. Built by
// flexflow_tpu_torch/ops/cuda/_build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes by
// flexflow_tpu_torch/ops/cuda/flash_kernel.py. The backward (#2, #3) is
// csrc/flash_bwd_kernel.cu; the helpers both share are in
// csrc/flash_common.cuh.
//
// What it replaces: flash_fwd_mma_kernel (head_dim up to 128) and
// flash_fwd_wide_kernel (past it) replace the Pallas TPU kernel
// _fwd_kernel of flexflow_tpu/ops/pallas/flash_kernel.py (:129, pallas_call
// in _fwd :198): O = softmax(Q K^T * scale, optionally causal) V with the
// row log-sum-exp LSE.
//
// What bounds it: operations. At the flagship shape (b 8, s 512, h 16,
// d 64) one forward is 2 products of depth 64 over 33.5 M (query, key)
// pairs, 8.59 GFLOP, against 67 MB of q, k, v, O and LSE: 128 flops a
// byte. Its products keep fp32 accuracy in three TF32 passes on the
// tensor cores (3 x 8.59 GFLOP at 495 TFLOP/s, 0.052 ms), as #2 and #3 do
// (flash_bwd_kernel.cu's header says why 3xTF32 and how the split works).
// The design:
//   * A block of 4 warps owns a 64-row query tile; each warp owns 16 rows.
//     It loops over 32-row key/value tiles, double-buffered with cp.async,
//     one __syncthreads per tile. The loop takes the place of the TPU's
//     sequential key grid axis.
//   * S = Q K^T goes into m16n8 accumulator fragments in registers, the
//     even and the odd k-steps into two accumulators so that two chains of
//     dependent mma's run side by side (what holds #2 and #3 on this card
//     is that latency).
//   * At head_dim <= 64 a block takes 51 KB of shared memory and at most
//     128 registers, so 4 blocks (16 warps) share an SM and the flagship's
//     1024 blocks run in 2 waves (at 3 blocks per SM: 2.59 waves). Q is
//     read from shared memory at every tile: keeping the warp's split Q
//     fragments in registers (64 more) held a block at 161 registers and
//     3 per SM, which measured slower.
//   * Scale, mask and the online softmax run on the fragments in base 2
//     (exp2 of s scale log2(e)): a row's 32 scores of a tile sit in the 4
//     lanes of a quad, whose max is taken with two __shfl_xor_sync; each
//     lane keeps its own partial row sum, rescaled with the running max
//     and summed over the quad once at the end.
//   * O += P V takes P's accumulator fragment as the A operand as it stands
//     (product_pn's permuted k order): no shared-memory round trip for P,
//     no barrier between the two products. Each 16 keys' part of O goes
//     into a fresh accumulator, added to O in fp32 (accumulate_pv says why).
//   * Tiles are staged row-major at a compile-time stride 8 kDT + 4 (free
//     of bank conflicts for both fragment reads), buckets kDT = 4, 8 or 16
//     column tiles of 8 (head_dim up to kMmaMaxD = 128).
//   * Causal: the mask is qpos >= kpos from a shared origin (also when
//     sq != sk); the loop stops at the diagonal key tile, a warp whose
//     rows see none of a tile skips it, and a warp whose 16 x 32 scores
//     are all visible skips the mask tests.
//   * Masked and padded entries weigh exactly 0 whatever the running max
//     is; a row that sees nothing gives O = 0 and no NaN (l >= 1e-30).
//     Rows past sq or sk are zero-filled by the copies and never stored.
//   * [b, s, h, d] operands are read in place through their strides: no
//     transpose to [b, h, s, d] (a layout artefact of the TPU tiling), and
//     LSE is [b, h, sq] rows, not the TPU's 128-lane broadcasts.
//
// Past head_dim 128 (any multiple of 8) flash_fwd_wide_kernel computes the
// same function. At [8, 512, 4, 320] one forward is 2 products of depth
// 320 over 8.4 M (query, key) pairs, 10.7 GFLOP (32 GFLOP of TF32 mma's in
// 3xTF32), against 84 MB of q, k, v and O: operations bound it. What it
// does about them:
//   * the scores once per (query tile, key tile): a block of 32 query
//     rows holds all of its output columns up to 512 over 8 warps (warp w
//     owns n-tiles 8u + w, both 16-row m-tiles, at most 64 accumulators a
//     thread). The warps split the score product by k-steps (each takes an
//     eighth of every 128-column piece, for all 32 x 32 scores), sum the
//     eight partials through shared memory, take the online softmax once
//     per row and hand P to the output warps as split 3xTF32 A fragments
//     (put_a). Past 512 columns grid z cuts chunks, each computing the
//     scores again. The kernel it replaced cut every width past 128 into
//     128-column chunks that each took the whole score product: 2, 3 and
//     4 score products per P V at 256, 320 and 512;
//   * 32-row query tiles: 128 blocks at [8, 256, 2, 512] for the card's
//     132 SMs (64-row tiles: 64);
//   * Q staged once: it stays resident for the whole key loop as unsplit
//     A fragments (32 d floats, one 16-byte read a fragment) up to
//     kWResidentD = 1216 (the widest that leaves room for the ring), and a
//     warp splits its fragments at every key tile (stored split, Q took
//     twice the shared memory and measured no faster); past 1216 Q's
//     pieces ride in the ring beside K's;
//   * copies under the products: K and V pieces (128 columns of 32 keys,
//     four TMA boxes of 32 fp32 columns, 128-byte swizzled) stream through
//     a ring on mbarriers, as many slots as shared memory leaves (up to
//     8: 8 at 320, 7 at 512), kept full by one thread of a producer warp,
//     so the consumers spend no instruction on a copy. In
//     the swizzle (16-byte chunk c of row r at c ^ r % 8) every fragment
//     read is free of bank conflicts: A and K's B read row g, column
//     8 ks + t (+4), V's B reads row 2t (+1), column 8j + g;
//   * accuracy as the fp32 bodies keep it: the tensor cores round an mma's
//     sum toward zero, so a warp's score chain takes a fresh accumulator
//     per piece (at most 2 of its k-steps), added in fp32, and P V a fresh
//     one per 16 keys; no atomics, so two calls give the same bits.
// On an H100 (700 W) it takes 0.297-0.301 / 0.349-0.356 / 0.067-0.068 ms
// of device time at [8, 512, 4, 256] / [8, 512, 4, 320] / [8, 256, 2,
// 512] (the kernels it replaced: 0.57-0.61 / 0.68-0.69 / 0.197-0.200;
// SDPA's forward 0.257-0.269 / 0.319-0.339 / 0.078-0.080), 91 TFLOP/s of
// TF32 work at 320; at 136 and 192 0.236-0.241 and 0.265 (replaced:
// 0.443 and 0.521-0.530; SDPA 0.191-0.197 and 0.208-0.215). Leaving
// either product out takes only ~20% off, a ring of 2 slots costs 0-5%,
// V's copies left out 0-4% (so neither the ring's latency nor the
// traffic from L2 holds it), cp.async in place of TMA costs 30-40%. What
// is left, a hypothesis that no measurement has tested yet (PERF.md's
// open questions): the per-tile sequence of waits and block barriers
// that one block of 9 warps an SM cannot hide
// (scripts/flash_fwd_fp32_variants.py times the ablations).
// wgmma's TF32 products need 64-row tiles, which would leave half the
// card idle at [8, 256, 2, 512], and K-major operands, which V in O += P V
// is not (ROADMAP Queue 2 notes the step).
// The v5e tiles (_TUNED = {"block_q": 512, "block_k": 1024}, set_tuned_blocks,
// the calibration table's flash_blocks) do not carry over: 64 x 32 and
// 32 x 32 tiles are what shared memory and the register file take here,
// and the ragged tail is masked, so any sequence length works.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

constexpr float kMask = -1e30f;

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// Blocks per SM the register cap aims at: 4 where head_dim <= 64 (at most
// 128 registers), so that the flagship's 1024 blocks take 2 waves of 528;
// shared memory holds 2 at 128 anyway.
__host__ __device__ constexpr int fwd_min_blocks(int kDT) { return kDT <= 8 ? 4 : 2; }

// s[j] = Q K_j^T over head_dim for the warp's 16 query rows (Q: the warp's
// first row) and the loop tile's kNT 8-key n-tiles, the even and the odd
// k-steps into two accumulators. Reads: Q[g][c], K[8j + g][c] with
// c = 8 ks + t (+4).
template <int kDT>
__device__ __forceinline__ void scores(const float* Q, const float* K, float s[kNT][4], int dt) {
  constexpr int ld = ld_of<kDT>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  Q += g * ld + t;
  K += g * ld + t;
  float s_odd[kNT][4];
  zero<kNT>(s);
  zero<kNT>(s_odd);
#pragma unroll
  for (int ks = 0; ks < kDT; ++ks) {
    if (ks < dt) {
      const int c = 8 * ks;
      const float a[4] = {Q[c], Q[8 * ld + c], Q[c + 4], Q[8 * ld + c + 4]};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(a[i], ab[i], as[i]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float b[2] = {K[8 * j * ld + c], K[8 * j * ld + c + 4]};
        if (ks & 1)
          mma3(s_odd[j], ab, as, b);
        else
          mma3(s[j], ab, as, b);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += s_odd[j][e];
}

// The online softmax over one tile's scores of rows r0, r0 + 8 (keys
// k0 + 8j + 2t (+1)), in base 2: s becomes P = 2^(s scale log2(e) - m_new)
// = exp(s scale - m_new ln 2), exactly 0 where masked (kMasked); the
// running max m (base 2), the lane's partial row sums l and O are rescaled
// to the new max.
template <bool kMasked, int kOT>
__device__ __forceinline__ void softmax_tile(const Params& p, int r0, int k0,
                                             float s[kNT][4], float m[2],
                                             float l[2], float o[kOT][4]) {
  const int t = threadIdx.x & 3;
  float mx[2] = {kMask, kMask};
#pragma unroll
  for (int j = 0; j < kNT; ++j)
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
  for (int j = 0; j < kNT; ++j)
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

// o[j] += P V[:, 8j : 8j + 8] over the tile's kLoop keys for the first cn
// of kOT n-tiles (V row-major at stride ld_of<kOT>()), with P's fragment
// as the A operand in product_pn's key order. Each 16 keys' sum goes into
// a fresh accumulator that is added to o in fp32: the tensor cores round
// an mma's sum toward zero, so O's accumulator, which lives through the
// whole loop, would otherwise drift toward zero by up to an ulp of itself
// per mma (3 kLoop / 4 of them a tile).
template <int kOT>
__device__ __forceinline__ void accumulate_pv(const float P[kNT][4], const float* V,
                                              float o[kOT][4], int cn) {
  constexpr int ld = ld_of<kOT>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  V += 2 * t * ld + g;
#pragma unroll
  for (int kp = 0; kp < kNT / 2; ++kp) {
    const float* v0 = V + 16 * kp * ld;  // keys 16 kp + 2t (+1), P[2 kp]
    const float* v1 = v0 + 8 * ld;       // keys 16 kp + 8 + 2t (+1), P[2 kp + 1]
    const float a0[4] = {P[2 * kp][0], P[2 * kp][2], P[2 * kp][1], P[2 * kp][3]};
    const float a1[4] = {P[2 * kp + 1][0], P[2 * kp + 1][2], P[2 * kp + 1][1], P[2 * kp + 1][3]};
    uint32_t ab0[4], as0[4], ab1[4], as1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split(a0[i], ab0[i], as0[i]);
      split(a1[i], ab1[i], as1[i]);
    }
#pragma unroll
    for (int j = 0; j < kOT; ++j) {
      if (j < cn) {
        const float b0[2] = {v0[8 * j], v0[ld + 8 * j]};
        const float b1[2] = {v1[8 * j], v1[ld + 8 * j]};
        float f[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(f, ab0, as0, b0);
        mma3(f, ab1, as1, b1);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] += f[e];
      }
    }
  }
}

template <int kDT>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks(kDT)) flash_fwd_mma_kernel(const Params p) {
  constexpr int ld = ld_of<kDT>();
  constexpr int ktile = kLoop * ld;
  extern __shared__ float4 smem4[];
  float* qsm = reinterpret_cast<float*>(smem4);  // Q [64][ld]
  float* ksm = qsm + kTile * ld;                  // K [2][kLoop][ld]
  float* vsm = ksm + 2 * ktile;                   // V [2][kLoop][ld]
  const int d = p.d, dt = d / 8;
  const int q0 = blockIdx.x * kTile, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* kb = p.k + ib * p.k_sb + ih * p.k_sh;
  const float* vb = p.v + ib * p.v_sb + ih * p.v_sh;
  load_tile<kTile>(qsm, ld, p.q + ib * p.q_sb + ih * p.q_sh, p.q_ss, q0, p.sq, d);
  load_tile<kLoop>(ksm, ld, kb, p.k_ss, 0, p.sk, d);
  load_tile<kLoop>(vsm, ld, vb, p.v_ss, 0, p.sk, d);
  cp_async_commit();

  const int w0 = q0 + 16 * warp, r0 = w0 + g;  // this lane's rows r0, r0 + 8
  const float* qw = qsm + 16 * warp * ld;

  float o[kDT][4];
  zero<kDT>(o);
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  const int k_end = p.causal ? min(p.sk, q0 + kTile) : p.sk;
  const int n = (k_end + kLoop - 1) / kLoop;
  for (int it = 0; it < n; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if (it + 1 < n) {
      const int nb = (it + 1) & 1;
      load_tile<kLoop>(ksm + nb * ktile, ld, kb, p.k_ss, (it + 1) * kLoop, p.sk, d);
      load_tile<kLoop>(vsm + nb * ktile, ld, vb, p.v_ss, (it + 1) * kLoop, p.sk, d);
      cp_async_commit();
    }
    const int k0 = it * kLoop;
    if (p.causal && w0 + 15 < k0) continue;  // the warp's rows see none of these keys
    const float* kt = ksm + (it & 1) * ktile;
    const float* vt = vsm + (it & 1) * ktile;
    float s[kNT][4];
    scores<kDT>(qw, kt, s, dt);
    const bool all = w0 + 16 <= p.sq && k0 + kLoop <= p.sk && (!p.causal || w0 >= k0 + kLoop - 1);
    if (all)
      softmax_tile<false, kDT>(p, r0, k0, s, m, l, o);
    else
      softmax_tile<true, kDT>(p, r0, k0, s, m, l, o);
    accumulate_pv<kDT>(s, vt, o, dt);  // O += P V
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
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] /= lnz[e >> 1];
  store_rows<kDT>(p.out0, ib, ih, p.h, p.sq, r0, d, dt, o);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r < p.sq) p.out1[((int64_t)ib * p.h + ih) * p.sq + r] = (m[i] + log2f(lnz[i])) * kLn2;
    }
  }
}

// -- head_dim past kMmaMaxD: flash_fwd_wide_kernel ------------------------------------
// One body for every head_dim past 128 (the design is in the header).
// A block of kWRows query rows runs 8 consumer warps and one producer
// warp. For each key tile of kWRows keys:
//   scores  S = Q K^T over the whole head_dim, once: the K pieces of the
//           tile come through the ring; in each piece each warp takes its
//           eighth of the k-steps for both 16-row m-tiles and all four
//           8-key n-tiles, into a fresh accumulator per piece added into
//           its partial scores, which go to shared memory;
//   softmax warp w sums the 8 partials of fragment (m-tile w / 4, n-tile
//           w % 4), takes the row max over the tile with the other three
//           warps of its m-tile through shared memory, and writes P as
//           split 3xTF32 A fragments (put_a) and the rows' correction;
//   output  O = O corr + P V: the V pieces of the block's columns come
//           through the ring; warp w owns n-tiles 8u + w over both m-tiles
//           and reads P's fragments once a tile; each 16 keys' part into a
//           fresh accumulator (accumulate_pv says why).
// Three barriers of the consumer warps a tile (named barrier 1); the ring
// runs on mbarriers (full: the producer's copy; empty: one arrival per
// consumer warp).

constexpr int kMmaMaxD = 128;                  // head_dims up to this run flash_fwd_mma_kernel
constexpr int kWRows = 32;                     // query rows of a block; keys of a tile
constexpr int kWWarps = 8;                     // consumer warps
// and the producer warp: nine warps, three of them on one sub-partition
// of the SM, whose 16,384 registers cap a thread at 168
constexpr int kWThreads = 32 * (kWWarps + 1);
constexpr int kWOT = 8;                        // output n-tiles of a consumer warp
constexpr int kWChunkTiles = kWWarps * kWOT;   // output n-tiles of a block: past it grid z cuts chunks
constexpr int kBox = 32 * 32;                  // floats of a box: 32 rows of 32 columns (128 bytes)
constexpr int kPieceBoxes = 4;                 // boxes of a ring item: 128 columns
constexpr int kPieceCols = 32 * kPieceBoxes;
constexpr int kWarpSteps = kPieceCols / 8 / kWWarps;  // k-steps (and V n-tiles) of a warp in a piece
constexpr int kMaxStages = 8;                 // ring slots: as many as shared memory leaves, at most this
constexpr int kStats = 10 * kWRows;            // row max and row-sum partials [4][32], corr, m
constexpr int kSmemMax = 232448;               // dynamic shared memory one block may take
// widest head_dim whose Q stays resident beside a ring of 2 slots
// (asserted below); past it Q's pieces ride in the ring beside K's
constexpr int kWResidentD = 1216;

// Floats of a ring slot: a piece of K or V, and of Q when Q is streamed.
__host__ __device__ constexpr int wide_slot(bool resident) { return (resident ? 1 : 2) * kPieceBoxes * kBox; }

// Shared bytes of the wide body besides its ring: the score partials (8
// warps x 2 m-tiles x 4 n-tiles of fragments), P's A fragments (2 m-tiles
// x 4 k-steps, big and small), the resident Q (dt k-steps x 2 m-tiles of
// unsplit A fragments: 32 d floats), the row statistics, the mbarriers, and
// 1024 bytes to align the ring to the swizzle's period.
__host__ __device__ constexpr int wide_fixed(int d, bool resident) {
  return 4 * (kWWarps * 8 * kFrag + 16 * kFrag + (resident ? 32 * d : 0) + kStats + 4 * kMaxStages) + 1024;
}

// Ring slots at head_dim d: what shared memory leaves, at most kMaxStages
// (one block an SM: its registers hold one anyway).
__host__ __device__ constexpr int wide_stages(int d, bool resident) {
  return (kSmemMax - wide_fixed(d, resident)) / (4 * wide_slot(resident)) < kMaxStages
             ? (kSmemMax - wide_fixed(d, resident)) / (4 * wide_slot(resident))
             : kMaxStages;
}

__host__ __device__ constexpr int wide_bytes(int d, bool resident) {
  return wide_fixed(d, resident) + 4 * wide_stages(d, resident) * wide_slot(resident);
}

static_assert(wide_stages(kWResidentD, true) >= 2 && wide_stages(kWResidentD + 8, true) < 2,
              "kWResidentD is the widest head_dim whose Q stays resident beside 2 ring slots");
static_assert(wide_stages(0, false) >= 2, "the streamed body holds 2 ring slots");

template <bool kResident>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_fwd_wide_kernel(const Params p, const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv) {
  constexpr int kSlot = wide_slot(kResident);
  const int stages = wide_stages(p.d, kResident);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));
  float* part = ring + stages * kSlot;        // [warp][m-tile][n-tile] score fragments
  float* pfrag = part + kWWarps * 8 * kFrag;  // P: [m-tile][k-step][big, small] A fragments
  float* qf = pfrag + 16 * kFrag;             // resident Q: [k-step][m-tile] A fragments
  float* rmax = qf + (kResident ? 32 * p.d : 0);  // [n-tile][row] maxima of a tile
  float* lpart = rmax + 4 * kWRows;               // [n-tile][row] row-sum partials
  float* corrs = lpart + 4 * kWRows;              // [row] the tile's correction
  float* mrow = corrs + kWRows;                   // [row] the running max at the end
  uint64_t* full = reinterpret_cast<uint64_t*>(mrow + kWRows);
  uint64_t* empty = full + kMaxStages;
  const int d = p.d, dt = d / 8;
  int c0t, cn;  // this block's output columns: n-tiles [c0t, c0t + cn)
  z_chunk(dt, c0t, cn);
  const int c0 = 8 * c0t;
  const int q0 = blockIdx.x * kWRows, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n = ((p.causal ? min(p.sk, q0 + kWRows) : p.sk) + kWRows - 1) / kWRows;  // key tiles
  const int kp = (d + kPieceCols - 1) / kPieceCols;                                  // K pieces a tile
  const int op = (8 * cn + kPieceCols - 1) / kPieceCols;                             // V pieces a tile
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], kWWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kWWarps) {  // the producer: one thread loads each tile's K pieces, then its V pieces
    if (lane != 0) return;
    hopper::prefetch_map(&tk);
    hopper::prefetch_map(&tv);
    if (!kResident) hopper::prefetch_map(&tq);
    int slot = 0, phase = 0;  // of the next item
    for (int it = 0; it < n; ++it) {
      const int k0 = it * kWRows;
      for (int r = 0; r < kp + op; ++r) {
        const bool score = r < kp;
        const int col = score ? r * kPieceCols : c0 + (r - kp) * kPieceCols;
        const int boxes = min(kPieceBoxes, ((score ? d : c0 + 8 * cn) - col + 31) / 32);
        const bool with_q = !kResident && score;
        float* dst = ring + slot * kSlot;
        hopper::mbar_wait(&empty[slot], phase ^ 1);
        // a box past the tensor's rows or columns arrives zero-filled
        hopper::mbar_expect_tx(&full[slot], (with_q ? 2 : 1) * boxes * kBox * 4);
        for (int b = 0; b < boxes; ++b) {
          hopper::tma_load_4d(dst + b * kBox, score ? &tk : &tv, &full[slot], col + 32 * b, k0, ih, ib);
          if (with_q)
            hopper::tma_load_4d(dst + (kPieceBoxes + b) * kBox, &tq, &full[slot], col + 32 * b, q0, ih, ib);
        }
        if (++slot == stages) slot = 0, phase ^= 1;
      }
    }
    return;
  }

  if constexpr (kResident) {
    // Q once, unsplit: element (r, c) is A-fragment slot (r / 8) % 2 +
    // 2 ((c % 8) / 4) of lane (r % 8, c % 4) in fragment (k-step c / 8,
    // m-tile r / 16)
    const float* qb = p.q + ib * p.q_sb + ih * p.q_sh;
    const int d4 = d / 4;
    for (int i = threadIdx.x; i < kWRows * d4; i += 32 * kWWarps) {
      const int r = i / d4, c = 4 * (i - r * d4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < p.sq) v = __ldg(reinterpret_cast<const float4*>(qb + (int64_t)(q0 + r) * p.q_ss + c));
      const float x[4] = {v.x, v.y, v.z, v.w};
      float* f = qf + ((c >> 3) * 2 + (r >> 4)) * kFrag + 16 * (r & 7) + ((r >> 3) & 1) + 2 * ((c >> 2) & 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) f[4 * e] = x[e];
    }
    hopper::bar_sync(1, 32 * kWWarps);
  }

  const float c = p.scale * kLog2e;
  const int pm = warp >> 2, pj = warp & 3;  // the softmax's fragment
  const int pr0 = 16 * pm + g;              // its rows pr0, pr0 + 8 of the block
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};  // their running max (base 2) and lane sums
  float o[2][kWOT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) zero<kWOT>(o[mt]);
  int slot = 0, phase = 0;  // of the next item
  for (int it = 0; it < n; ++it) {
    const int k0 = it * kWRows;
    float s[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) zero<4>(s[mt]);
    for (int pc = 0; pc < kp; ++pc) {
      const float* sl = ring + slot * kSlot;
      const int ks = min(kPieceCols, d - pc * kPieceCols) / 8;  // k-steps of the piece
      const int ka = warp * ks / kWWarps, kb = (warp + 1) * ks / kWWarps;
      hopper::mbar_wait(&full[slot], phase);
      float f[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) zero<4>(f[mt]);
#pragma unroll
      for (int u = 0; u < kWarpSteps; ++u) {
        const int kk = ka + u;
        if (kk < kb) {
          const int bx = kk >> 2, cc = 8 * (kk & 3) + t;  // box, and the lane's column in it
          uint32_t ab[2][4], as[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float a[4];
            if constexpr (kResident) {
              const float4 x = *reinterpret_cast<const float4*>(
                  qf + ((pc * (kPieceCols / 8) + kk) * 2 + mt) * kFrag + 4 * lane);
              a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
            } else {
              const float* qt = sl + (kPieceBoxes + bx) * kBox;
              a[0] = qt[swz(16 * mt + g, cc)], a[1] = qt[swz(16 * mt + g + 8, cc)];
              a[2] = qt[swz(16 * mt + g, cc + 4)], a[3] = qt[swz(16 * mt + g + 8, cc + 4)];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) split(a[i], ab[mt][i], as[mt][i]);
          }
          const float* kt = sl + bx * kBox;
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) {
            uint32_t bb[2], bs[2];
            split(kt[swz(8 * jn + g, cc)], bb[0], bs[0]);
            split(kt[swz(8 * jn + g, cc + 4)], bb[1], bs[1]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma3_split(f[mt][jn], ab[mt], as[mt], bb, bs);
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[slot]);
      if (++slot == stages) slot = 0, phase ^= 1;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][jn][e] += f[mt][jn][e];
    }
    {
      float4* pw = reinterpret_cast<float4*>(part) + warp * 8 * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
          pw[(4 * mt + jn) * 32] = make_float4(s[mt][jn][0], s[mt][jn][1], s[mt][jn][2], s[mt][jn][3]);
    }
    hopper::bar_sync(1, 32 * kWWarps);  // the partials are in

    // the softmax of fragment (pm, pj): rows pr0, pr0 + 8, keys 8 pj + 2t (+1)
    float sv[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const float4* pr = reinterpret_cast<const float4*>(part) + (4 * pm + pj) * 32 + lane;
#pragma unroll
      for (int w = 0; w < kWWarps; ++w) {
        const float4 x = pr[w * 8 * 32];
        sv[0] += x.x, sv[1] += x.y, sv[2] += x.z, sv[3] += x.w;
      }
    }
    const bool all = q0 + kWRows <= p.sq && k0 + kWRows <= p.sk && (!p.causal || q0 >= k0 + kWRows - 1);
    float mx[2] = {kMask, kMask};
    bool ok[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sv[e] *= c;
      ok[e] = all || visible(p, q0 + pr0 + 8 * (e >> 1), k0 + 8 * pj + 2 * t + (e & 1));
      if (ok[e]) mx[e >> 1] = fmaxf(mx[e >> 1], sv[e]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    if (t == 0) {
      rmax[pj * kWRows + pr0] = mx[0];
      rmax[pj * kWRows + pr0 + 8] = mx[1];
    }
    hopper::bar_sync(1, 32 * kWWarps);  // the n-tiles' maxima are in
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m_new = m[i];
#pragma unroll
      for (int q = 0; q < 4; ++q) m_new = fmaxf(m_new, rmax[q * kWRows + pr0 + 8 * i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
    float pv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pv[e] = ok[e] ? exp2f(sv[e] - m[e >> 1]) : 0.f;
      l[e >> 1] += pv[e];
    }
    {
      float* fa = pfrag + (4 * pm + pj) * 2 * kFrag + 4 * lane;
      put_a<false>(fa, fa + kFrag, pv);
    }
    if (pj == 0 && t == 0) {
      corrs[pr0] = corr[0];
      corrs[pr0 + 8] = corr[1];
    }
    hopper::bar_sync(1, 32 * kWWarps);  // P and the corrections are in

    // O = O corr + P V over the block's columns
    uint32_t pb[2][4][4], ps[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* fa = pfrag + (4 * mt + kk) * 2 * kFrag + 4 * lane;
        get_a<false>(fa, fa + kFrag, pb[mt][kk], ps[mt][kk]);
      }
      const float c_lo = corrs[16 * mt + g], c_hi = corrs[16 * mt + g + 8];
#pragma unroll
      for (int u = 0; u < kWOT; ++u) {
        o[mt][u][0] *= c_lo, o[mt][u][1] *= c_lo;
        o[mt][u][2] *= c_hi, o[mt][u][3] *= c_hi;
      }
    }
#pragma unroll
    for (int pc = 0; pc < kWOT / kWarpSteps; ++pc) {
      if (pc < op) {
        const float* vt = ring + slot * kSlot;
        hopper::mbar_wait(&full[slot], phase);
#pragma unroll
        for (int i = 0; i < kWarpSteps; ++i) {
          const int nt = kWWarps * i + warp;  // the warp's n-tile of the piece
          if (kPieceCols / 8 * pc + nt < cn) {
            const float* vb = vt + (nt >> 2) * kBox;
            const int cc = 8 * (nt & 3) + g;
#pragma unroll
            for (int kh = 0; kh < 2; ++kh) {
              float f[2][4] = {};
#pragma unroll
              for (int kk = 2 * kh; kk < 2 * kh + 2; ++kk) {
                // B: keys 8 kk + 2t (+1), the lane's column of the n-tile
                uint32_t bb[2], bs[2];
                split(vb[swz(8 * kk + 2 * t, cc)], bb[0], bs[0]);
                split(vb[swz(8 * kk + 2 * t + 1, cc)], bb[1], bs[1]);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) mma3_split(f[mt], pb[mt][kk], ps[mt][kk], bb, bs);
              }
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[mt][kWarpSteps * pc + i][e] += f[mt][e];
            }
          }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[slot]);
        if (++slot == stages) slot = 0, phase ^= 1;
      }
    }
  }

  // l over the quad and the four n-tiles' warps of each row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (t == 0) {
    lpart[pj * kWRows + pr0] = l[0];
    lpart[pj * kWRows + pr0 + 8] = l[1];
    if (pj == 0) {
      mrow[pr0] = m[0];
      mrow[pr0 + 8] = m[1];
    }
  }
  hopper::bar_sync(1, 32 * kWWarps);
  const auto lnz = [&](int r) {
    return fmaxf(lpart[r] + lpart[kWRows + r] + lpart[2 * kWRows + r] + lpart[3 * kWRows + r], 1e-30f);
  };
  const int mine = (cn - warp + 7) / 8;  // this warp's n-tiles 8u + warp below cn
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float lo = lnz(16 * mt + g), hi = lnz(16 * mt + g + 8);
#pragma unroll
    for (int u = 0; u < kWOT; ++u) {
      o[mt][u][0] /= lo, o[mt][u][1] /= lo;
      o[mt][u][2] /= hi, o[mt][u][3] /= hi;
    }
    store_rows<kWOT, float, 8>(p.out0 + c0 + 8 * warp, ib, ih, p.h, p.sq, q0 + 16 * mt + g, d, mine, o[mt]);
  }
  if (blockIdx.z == 0 && (int)threadIdx.x < kWRows && q0 + (int)threadIdx.x < p.sq) {
    const int r = threadIdx.x;
    p.out1[((int64_t)ib * p.h + ih) * p.sq + q0 + r] = (mrow[r] + log2f(lnz(r))) * kLn2;
  }
}

// -- launch ----------------------------------------------------------------------------

bool wide(int d) { return d > kMmaMaxD; }

bool resident(int d) { return d <= kWResidentD; }

// the Q tile, and 2 K tiles and 2 V tiles of kLoop rows, at the bucket's
// stride; past kMmaMaxD wide_bytes
size_t smem_bytes(int d) {
  if (wide(d)) return wide_bytes(d, resident(d));
  const size_t ld = 8 * (4 << bucket(d)) + 4;
  return (kTile + 4 * kLoop) * ld * sizeof(float);
}

// 0-2: the mma kernels' buckets; 3 the wide body with Q resident, 4 with Q streamed
int slot_of(int d) { return wide(d) ? (resident(d) ? 3 : 4) : bucket(d); }

void* kernel_of(int d) {
  static void* const table[5] = {(void*)flash_fwd_mma_kernel<4>, (void*)flash_fwd_mma_kernel<8>,
                                 (void*)flash_fwd_mma_kernel<16>, (void*)flash_fwd_wide_kernel<true>,
                                 (void*)flash_fwd_wide_kernel<false>};
  return table[slot_of(d)];
}

int threads_of(int d) { return wide(d) ? kWThreads : kThreads; }

// Sets each kernel's shared-memory cap once: its size, for the wide body
// all a block may take (its ring takes what the rest leaves).
int configure(int d) {
  static bool configured[5] = {};
  const int si = slot_of(d);
  if (configured[si]) return 0;
  const int bytes = wide(d) ? kSmemMax : (int)smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(kernel_of(d), cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel_of(d), cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  configured[si] = true;
  return 0;
}

int launch(const Params& p, int b, cudaStream_t stream) {
  if (!takes(p.d)) return (int)cudaErrorInvalidValue;
  const int err = configure(p.d);
  if (err) return err;
  if (!wide(p.d)) {
    dim3 grid((p.sq + kTile - 1) / kTile, b * p.h);
    void* args[] = {(void*)&p};
    cudaError_t e = cudaLaunchKernel(kernel_of(p.d), grid, dim3(kThreads), args, smem_bytes(p.d), stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  // q, k and v in boxes of 32 columns x kWRows rows, encoded per call
  CUtensorMap maps[3];
  const float* ptr[3] = {p.q, p.k, p.v};
  const int64_t st[3][3] = {{p.q_sb, p.q_ss, p.q_sh}, {p.k_sb, p.k_ss, p.k_sh}, {p.v_sb, p.v_ss, p.v_sh}};
  for (int i = 0; i < 3; ++i) {
    const int e = hopper::encode_bshd_f32(&maps[i], ptr[i], b, i == 0 ? p.sq : p.sk, p.h, p.d, st[i][0], st[i][1],
                                          st[i][2], kWRows);
    if (e) return e;
  }
  dim3 grid((p.sq + kWRows - 1) / kWRows, b * p.h, (p.d / 8 + kWChunkTiles - 1) / kWChunkTiles);
  if (resident(p.d))
    flash_fwd_wide_kernel<true><<<grid, kWThreads, smem_bytes(p.d), stream>>>(p, maps[0], maps[1], maps[2]);
  else
    flash_fwd_wide_kernel<false><<<grid, kWThreads, smem_bytes(p.d), stream>>>(p, maps[0], maps[1], maps[2]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ff_flash_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// What one block of the forward at head_dim d takes and how many fit an
// SM: out = {registers per thread, local (spill) bytes per thread, dynamic
// shared bytes, threads, blocks per SM}.
int ff_flash_occupancy(int d, int* out) {
  if (!takes(d)) return (int)cudaErrorInvalidValue;
  const int err = configure(d);
  if (err) return err;
  return flash::occupancy(kernel_of(d), smem_bytes(d), out, threads_of(d));
}

// q [b, sq, h, d], k/v [b, sk, h, d] fp32 with head_dim contiguous and
// 16-byte aligned rows; o contiguous [b, sq, h, d]; lse contiguous [b, h, sq].
// Returns cudaGetLastError() after the launch.
int ff_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                     void* lse, int b, int h, int sq, int sk, int d,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     float scale, int causal, void* stream) {
  Params p{(const float*)q, (const float*)k, (const float*)v, nullptr, nullptr, nullptr,
           (float*)o, (float*)lse, h, sq, sk, d,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, 0, 0, 0, scale, causal};
  return launch(p, b, (cudaStream_t)stream);
}

}  // extern "C"
