// Flash attention forward for Hopper (sm_90a), fp32 in and out, products on
// the tensor cores in 3xTF32: the device body of kernel #1. Built by
// flexflow_tpu_torch/ops/cuda/_build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes by
// flexflow_tpu_torch/ops/cuda/flash_kernel.py. The backward (#2, #3) is
// csrc/flash_bwd_kernel.cu; the helpers both share are in
// csrc/flash_common.cuh.
//
// What it replaces: flash_fwd_mma_kernel replaces the Pallas TPU kernel
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
//     of bank conflicts for both fragment reads), buckets kDT = 4, 8, 16
//     or 32 column tiles of 8.
//   * head_dim above 128 (up to 256): a grid z index picks a chunk of at
//     most 128 output columns. Each block contracts the scores over the
//     whole head_dim (Q and K staged at full width) and accumulates only
//     its chunk of O, staging only that chunk of V; the scores are
//     recomputed once per chunk. Chunk 0 writes LSE.
//   * head_dim above 256 (any multiple of 8): flash_fwd_wide_kernel, the
//     same chunks, with the score contraction streamed over head_dim in
//     128-column pieces of Q and K (single-buffered, so shared memory does
//     not grow with head_dim) and a fresh accumulator per k-step.
//   * Causal: the mask is qpos >= kpos from a shared origin (also when
//     sq != sk); the loop stops at the diagonal key tile, a warp whose
//     rows see none of a tile skips it, and a warp whose 16 x 32 scores
//     are all visible skips the mask tests.
//   * Masked and padded entries weigh exactly 0 whatever the running max
//     is; a row that sees nothing gives O = 0 and no NaN (l >= 1e-30).
//     Rows past sq or sk are zero-filled by the copies and never stored.
//   * [b, s, h, d] operands are read in place through their strides: no
//     transpose to [b, h, s, d] (a layout artefact of the TPU tiling), and
//     LSE is [b, h, s] rows, not the TPU's 128-lane broadcasts.
// The v5e tiles (_TUNED = {"block_q": 512, "block_k": 1024}, set_tuned_blocks,
// the calibration table's flash_blocks) do not carry over: 64 x 32 tiles
// are what shared memory and the register file take here, and the ragged
// tail is masked, so any sequence length works.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr float kMask = -1e30f;

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// Blocks per SM the register cap aims at: 4 where head_dim <= 64 (at most
// 128 registers), so that the flagship's 1024 blocks take 2 waves of 528;
// shared memory holds 2 at 128 and 1 past it anyway.
__host__ __device__ constexpr int fwd_min_blocks(int kDT) { return kDT <= 8 ? 4 : kDT <= 16 ? 2 : 1; }

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
  constexpr int kOT = out_tiles<kDT>();
  constexpr int ld = ld_of<kDT>(), vld = ld_of<kOT>();
  constexpr int ktile = kLoop * ld, vtile = kLoop * vld;
  extern __shared__ float4 smem4[];
  float* qsm = reinterpret_cast<float*>(smem4);  // Q [64][ld]
  float* ksm = qsm + kTile * ld;                  // K [2][kLoop][ld]
  float* vsm = ksm + 2 * ktile;                   // V [2][kLoop][vld], this block's columns
  const int d = p.d, dt = d / 8;
  int c0t, cn;
  out_chunk<kDT>(dt, c0t, cn);
  const int c0 = 8 * c0t;
  const int q0 = blockIdx.x * kTile, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* kb = p.k + ib * p.k_sb + ih * p.k_sh;
  const float* vb = p.v + ib * p.v_sb + ih * p.v_sh + c0;
  load_tile<kTile>(qsm, ld, p.q + ib * p.q_sb + ih * p.q_sh, p.q_ss, q0, p.sq, d);
  load_tile<kLoop>(ksm, ld, kb, p.k_ss, 0, p.sk, d);
  load_tile<kLoop>(vsm, vld, vb, p.v_ss, 0, p.sk, 8 * cn);
  cp_async_commit();

  const int w0 = q0 + 16 * warp, r0 = w0 + g;  // this lane's rows r0, r0 + 8
  const float* qw = qsm + 16 * warp * ld;

  float o[kOT][4];
  zero<kOT>(o);
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  const int k_end = p.causal ? min(p.sk, q0 + kTile) : p.sk;
  const int n = (k_end + kLoop - 1) / kLoop;
  for (int it = 0; it < n; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if (it + 1 < n) {
      const int nb = (it + 1) & 1;
      load_tile<kLoop>(ksm + nb * ktile, ld, kb, p.k_ss, (it + 1) * kLoop, p.sk, d);
      load_tile<kLoop>(vsm + nb * vtile, vld, vb, p.v_ss, (it + 1) * kLoop, p.sk, 8 * cn);
      cp_async_commit();
    }
    const int k0 = it * kLoop;
    if (p.causal && w0 + 15 < k0) continue;  // the warp's rows see none of these keys
    const float* kt = ksm + (it & 1) * ktile;
    const float* vt = vsm + (it & 1) * vtile;
    float s[kNT][4];
    scores<kDT>(qw, kt, s, dt);
    const bool all = w0 + 16 <= p.sq && k0 + kLoop <= p.sk && (!p.causal || w0 >= k0 + kLoop - 1);
    if (all)
      softmax_tile<false, kOT>(p, r0, k0, s, m, l, o);
    else
      softmax_tile<true, kOT>(p, r0, k0, s, m, l, o);
    accumulate_pv<kOT>(s, vt, o, cn);  // O += P V
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
      if (r < p.sq) p.out1[((int64_t)ib * p.h + ih) * p.sq + r] = (m[i] + log2f(lnz[i])) * kLn2;
    }
  }
}

// -- head_dim past kStagedMaxD ---------------------------------------------------------

// s[j] += Q K_j^T over one piece of head_dim: pt of its kPieceTiles k-steps
// (Q: the warp's first row, both staged at ld_of<kPieceTiles>()). Each
// k-step's 3 passes go into a fresh accumulator added to s in fp32
// (product_nt's kFresh), so the round-toward-zero error does not build up
// along the head_dim-long chain.
__device__ __forceinline__ void scores_piece(const float* Q, const float* K, float s[kNT][4], int pt) {
  constexpr int ld = ld_of<kPieceTiles>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  Q += g * ld + t;
  K += g * ld + t;
#pragma unroll
  for (int ks = 0; ks < kPieceTiles; ++ks) {
    if (ks < pt) {
      const int c = 8 * ks;
      const float a[4] = {Q[c], Q[8 * ld + c], Q[c + 4], Q[8 * ld + c + 4]};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(a[i], ab[i], as[i]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float b[2] = {K[8 * j * ld + c], K[8 * j * ld + c + 4]};
        float f[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(f, ab, as, b);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += f[e];
      }
    }
  }
}

// #1 at any head_dim past kStagedMaxD. The full-width Q tile and key tile
// no longer fit shared memory, so for each key tile the score contraction
// streams over head_dim: one kPieceTiles-wide piece of Q and of K staged at
// a time, single-buffered, each piece's products added into the scores.
// The block's chunk of V (grid z, at most 128 columns) then takes the key
// piece's buffer. Shared memory stays at (64 + 32) rows of 132 floats
// whatever head_dim is; Q is staged again for every key tile. Every
// barrier is reached by all warps: a warp whose rows see none of a causal
// tile skips only its products. (bf16 past kStagedMaxD runs
// csrc/flash_bf16_kernel.cu's flash_fwd_wide_bf16_kernel.)
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_wide_kernel(const Params p) {
  constexpr int kPT = kPieceTiles, ld = ld_of<kPT>();
  extern __shared__ float4 smem4[];
  float* qsm = reinterpret_cast<float*>(smem4);  // Q piece [64][ld]
  float* ksm = qsm + kTile * ld;                  // K piece, then V chunk [kLoop][ld]
  const int d = p.d, dt = d / 8, pieces = (dt + kPT - 1) / kPT;
  int c0t, cn;
  z_chunk(dt, c0t, cn);
  const int c0 = 8 * c0t;
  const int q0 = blockIdx.x * kTile, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* qb = p.q + ib * p.q_sb + ih * p.q_sh;
  const float* kb = p.k + ib * p.k_sb + ih * p.k_sh;
  const float* vb = p.v + ib * p.v_sb + ih * p.v_sh + c0;
  const int w0 = q0 + 16 * warp, r0 = w0 + g;  // this lane's rows r0, r0 + 8
  const float* qw = qsm + 16 * warp * ld;

  float o[kPT][4];
  zero<kPT>(o);
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  const int k_end = p.causal ? min(p.sk, q0 + kTile) : p.sk;
  const int n = (k_end + kLoop - 1) / kLoop;
  for (int it = 0; it < n; ++it) {
    const int k0 = it * kLoop;
    const bool sees = !(p.causal && w0 + 15 < k0);
    float s[kNT][4];
    zero<kNT>(s);
    for (int pc = 0; pc < pieces; ++pc) {
      const int pt = min(kPT, dt - pc * kPT);
      __syncthreads();  // every warp is done with the buffers
      load_tile<kTile>(qsm, ld, qb + 8 * kPT * pc, p.q_ss, q0, p.sq, 8 * pt);
      load_tile<kLoop>(ksm, ld, kb + 8 * kPT * pc, p.k_ss, k0, p.sk, 8 * pt);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();  // the piece is in
      if (sees) scores_piece(qw, ksm, s, pt);
    }
    __syncthreads();  // every warp is done with the last key piece
    load_tile<kLoop>(ksm, ld, vb, p.v_ss, k0, p.sk, 8 * cn);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // the V chunk is in
    if (!sees) continue;
    const bool all = w0 + 16 <= p.sq && k0 + kLoop <= p.sk && (!p.causal || w0 >= k0 + kLoop - 1);
    if (all)
      softmax_tile<false, kPT>(p, r0, k0, s, m, l, o);
    else
      softmax_tile<true, kPT>(p, r0, k0, s, m, l, o);
    accumulate_pv<kPT>(s, ksm, o, cn);  // O += P V
  }

  float lnz[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lnz[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < kPT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] /= lnz[e >> 1];
  store_rows<kPT>(p.out0 + c0, ib, ih, p.h, p.sq, r0, d, cn, o);
  if (blockIdx.z == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r < p.sq) p.out1[((int64_t)ib * p.h + ih) * p.sq + r] = (m[i] + log2f(lnz[i])) * kLn2;
    }
  }
}

// -- launch ----------------------------------------------------------------------------

// the Q tile, and 2 K tiles and 2 V tiles (this block's columns) of kLoop
// rows, at the bucket's strides; past kStagedMaxD one Q piece and one key
// piece (which the V chunk reuses)
size_t smem_bytes(int d) {
  if (bucket(d) == 4) return (size_t)(kTile + kLoop) * ld_of<kPieceTiles>() * sizeof(float);
  const int kdt = 4 << bucket(d), kot = kdt < kChunkTiles ? kdt : kChunkTiles;
  const size_t ld = 8 * kdt + 4, vld = 8 * kot + 4;
  return ((kTile + 2 * kLoop) * ld + 2 * kLoop * vld) * sizeof(float);
}

void* kernel_of(int d) {
  static void* const table[5] = {(void*)flash_fwd_mma_kernel<4>, (void*)flash_fwd_mma_kernel<8>,
                                 (void*)flash_fwd_mma_kernel<16>, (void*)flash_fwd_mma_kernel<32>,
                                 (void*)flash_fwd_wide_kernel};
  return table[bucket(d)];
}

int configure(int d) {
  static bool configured[5] = {};
  const int bi = bucket(d);
  if (configured[bi]) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel_of(d), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes(d));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel_of(d), cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  configured[bi] = true;
  return 0;
}

int launch(const Params& p, int b, cudaStream_t stream) {
  if (!takes(p.d)) return (int)cudaErrorInvalidValue;
  const int err = configure(p.d);
  if (err) return err;
  dim3 grid((p.sq + kTile - 1) / kTile, b * p.h, chunks(p.d));
  void* args[] = {(void*)&p};
  cudaError_t e = cudaLaunchKernel(kernel_of(p.d), grid, dim3(kThreads), args, smem_bytes(p.d), stream);
  if (e != cudaSuccess) return (int)e;
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
  return flash::occupancy(kernel_of(d), smem_bytes(d), out);
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
