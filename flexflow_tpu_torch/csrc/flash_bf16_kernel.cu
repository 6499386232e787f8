// Flash attention forward and backward for Hopper (sm_90a) on bf16 operands:
// the device bodies of kernels #1, #2 and #3 under mixed precision. Built by
// flexflow_tpu_torch/ops/cuda/_build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes by
// flexflow_tpu_torch/ops/cuda/flash_kernel.py. The fp32 bodies are
// csrc/flash_kernel.cu (#1) and csrc/flash_bwd_kernel.cu (#2, #3; its wide
// kernels also take #2 and #3 at bf16 past head_dim 256). Every body here
// (#1 at any head_dim, #2 and #3 up to 256) is built from csrc/hopper.cuh
// (TMA, mbarriers, wgmma); csrc/flash_common.cuh gives the occupancy query.
//
// What it replaces: the Pallas TPU kernels of
// flexflow_tpu/ops/pallas/flash_kernel.py at bf16 inputs, which keep f32
// scratch accumulators and an f32 LSE and cast the second product's
// operand to the input dtype:
//   * flash_fwd_bf16_wgmma_kernel (head_dim up to 256) and
//     flash_fwd_wide_bf16_wgmma_kernel (past it, any multiple of 8) replace
//     _fwd_kernel (:129, pallas_call :198):
//     S = scale Q K^T in f32, the online softmax in f32, P rounded to bf16
//     (:158) for O += P V in f32 while l sums the f32 P; O = acc / max(l,
//     1e-30) rounded to bf16 (both bodies multiply by the f32
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
// #1 past head_dim 256 (flash_fwd_wide_bf16_wgmma_kernel<kB>). Its bound
// at [8, 512, 4, 320]: 10.7 GFLOP (0.0109 ms at 989 TFLOP/s) against 41.9
// MB (0.0125 ms at 3.35 TB/s), so bytes. The body it replaced (one-pass
// bf16 mma.sync, 8 warps of 16 rows, a cp.async ring) took 0.1677 ms
// there, 2.0x bf16 SDPA's forward; what this design does about each of
// its causes (measured on an H100 at [8, 512, 4, 320] and [8, 256, 2,
// 512], scripts/flash_fwd_wide_bf16_variants.py):
//   * the scores computed again for every 128-column chunk of O (3 score
//     products per P V at 320): a work tile holds O for kB 64-column
//     boxes, kB up to kMaxBoxes = 4 (256 columns, 128 f32 a thread), so
//     the scores run once per chunk of up to 256 columns (at 320 two
//     chunks of 3 boxes). 5 boxes (320 columns, 160 f32 of O) do not fit
//     setmaxnreg's 240 registers beside S, a later chain and P: 344-684
//     bytes of spills with the wgmma's serialized by ptxas (C7511),
//     slower than two chunks (chunks_320);
//   * mma.sync at 16 rows a warp, every operand a warp's own ldmatrix:
//     both products are wgmma m64nNk16 by a warpgroup of 64 rows, S = Q
//     K^T SS over K-major boxes, O += P V RS with V MN-major, N = 64 a
//     box, P packed where it stands (to_fragments);
//   * the compute threads copying, a block barrier per item: a producer
//     warpgroup (one thread, 24 registers) feeds a ring of 64-column
//     boxes by TMA, a full and an empty mbarrier a slot: per key tile nb
//     K boxes, then the chunk's kB V boxes. The 128-row Q tile stays
//     resident up to kWideResidentD (640) beside at least kMinSlots
//     slots; past it each Q box rides in the slot of its K box, so any
//     multiple of 8 runs here. The ring takes what shared memory leaves,
//     up to kMaxSlots (18 slots at 320, 12 at 512);
//   * a one-shot grid: persistent, one block an SM walking (query tiles,
//     the last first) x (b h) x chunks; wide_boxes picks kB from the
//     waves it gives (at [8, 256, 2, 512] 4 chunks of 2 boxes, 128 work
//     tiles, in place of 2 of 4 on 64 of the 132 SMs).
// Two consumer warpgroups of 64 query rows share every box. Per key tile
// a warpgroup issues P V of tile j - 1 and S's first chain (into s), waits
// for P V (P's registers and V's boxes free), then issues S's later
// chains (into u, each added to s in f32 once done); the softmax runs
// under the other warpgroup's products. Turns on named barriers, as the
// body up to 256 takes them (ping_pong), were slower: a turn has to span
// the waits for the boxes and for P V. Accuracy: the tensor cores
// truncate the sum of each k16 step of a chain (issue_score_pair's
// note), so S runs in fresh chains of kChain boxes (16 k16 steps, the
// longest chain of the body up to 256) added in f32; in a CPU model
// (tests/test_torch_flash_kernel.py) one chain over 1032 columns left
// LSE 5.1e-6 off at one visible key, fresh chains 9.7e-7. Causal: key
// tiles past a work tile's last row are never loaded; tiles crossing sk
// or the diagonal of a warpgroup's rows test one limit a row per entry.
// Rows past s and columns past d arrive as zeros (whole V boxes past d
// too). No atomics: two calls give the same bits.

#include <cuda_bf16.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kStagedD = 256;     // widest head_dim of the wgmma bodies
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

// (lo, hi) rounded to nearest even, packed with lo in the lower half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// -- #1 past head_dim 256: wgmma over a TMA ring of 64-column boxes ------------------------

// Shape of the wide forward's block (the header says why each number).
struct Wide {
  static constexpr int kWG = 2;                     // consumer warpgroups, 64 query rows each
  static constexpr int kM = 64 * kWG;               // query rows of a block
  static constexpr int kN = 64;                     // key rows of a loop tile
  static constexpr int kMaxBoxes = 4;               // 64-column boxes of an output chunk: O's 256 columns at most
  static constexpr int kChain = 4;                  // boxes of one fresh score chain: 16 k16 steps
  static constexpr int kThreads = 128 * (kWG + 1);  // a producer warpgroup and the consumers
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr int kBox = kN * 128, kQBox = kM * 128;  // bytes of a K or V box, of a Q box
  static constexpr int kMaxSlots = 32;              // ring slots at most
  static constexpr int kFixed = 1024 + 8 * (2 + 2 * kMaxSlots);  // alignment and mbarriers
  // boxes a consumer warpgroup holds at once: V(j - 1)'s and the first
  // chain of K(j), then two chains of K(j)
  static constexpr int kMinSlots = kMaxBoxes + kChain > 2 * kChain ? kMaxBoxes + kChain : 2 * kChain;
};
static_assert(Wide::kThreads == Fwd<64>::kThreads, "one block shape for every forward body");

constexpr int kSmemMax = 232448;  // dynamic shared memory one block may take

// bytes of a ring slot: a K box and, with Q streamed, its Q box (a V box
// takes the K box's place)
__host__ __device__ constexpr int wide_slot(bool resident) { return Wide::kBox + (resident ? 0 : Wide::kQBox); }

// ring slots at nb boxes of head_dim: what shared memory leaves beside the
// resident Q tile (resident) or all of it, at most kMaxSlots
__host__ __device__ constexpr int wide_slots(int nb, bool resident) {
  return (kSmemMax - Wide::kFixed - (resident ? nb * Wide::kQBox : 0)) / wide_slot(resident) < Wide::kMaxSlots
             ? (kSmemMax - Wide::kFixed - (resident ? nb * Wide::kQBox : 0)) / wide_slot(resident)
             : Wide::kMaxSlots;
}

// Q stays resident while the ring beside it holds kMinSlots
__host__ __device__ constexpr bool wide_resident(int nb) { return wide_slots(nb, true) >= Wide::kMinSlots; }

constexpr int kWideResidentD = 640;  // the widest head_dim whose Q tile stays resident
static_assert(wide_resident(kWideResidentD / 64) && !wide_resident(kWideResidentD / 64 + 1),
              "kWideResidentD is the widest head_dim whose Q tile leaves kMinSlots ring slots");
static_assert(wide_slots(0, false) >= Wide::kMinSlots, "the streamed ring holds kMinSlots slots");

// dynamic shared bytes of the wide forward at nb boxes of head_dim
size_t wide_bytes(int nb) {
  const bool r = wide_resident(nb);
  return Wide::kFixed + (size_t)(r ? nb * Wide::kQBox : 0) + (size_t)wide_slots(nb, r) * wide_slot(r);
}

// The wide forward's grid: (b h) x mt query tiles x nch output chunks
// over nb boxes of head_dim, and its ring of `slots` slots beside Q
// (resident) or holding it.
struct WideGrid {
  int bh, mt, nb, nch, slots, resident;
};

// a ring slot and the parity of its fill
struct Slot {
  int i, phase;
};

// the slot k boxes after s in a ring of n
__device__ __forceinline__ Slot slot_at(Slot s, int k, int n) {
  const int x = s.i + k, w = x / n;
  return {x - w * n, s.phase ^ (w & 1)};
}

// Work tile t, the last query tiles (the longest when causal) first and
// within one the (b h) x output chunks: batch ib, head ih, first row q0,
// chunk ch, and n, the key tiles it reads.
struct WideTile {
  int ib, ih, q0, ch, n;
};

__device__ __forceinline__ WideTile wide_tile(const Params& p, const WideGrid& w, int t) {
  WideTile r;
  const int per = w.bh * w.nch, rest = t % per;
  r.q0 = (w.mt - 1 - t / per) * Wide::kM;
  r.ch = rest % w.nch;
  r.ib = rest / w.nch / p.h;
  r.ih = rest / w.nch % p.h;
  const int k_end = p.causal ? min(p.sk, r.q0 + Wide::kM) : p.sk;
  r.n = (k_end + Wide::kN - 1) / Wide::kN;
  return r;
}

// acc = Q K^T over kCnt boxes of head_dim, one fresh chain: the
// warpgroup's 64 rows of the Q box at shared address qb[x] against the
// kN keys of the K box at kb[x], both K-major.
template <int kCnt>
__device__ __forceinline__ void issue_chain(float (&acc)[Wide::kN / 2], const uint32_t (&qb)[Wide::kChain],
                                            const uint32_t (&kb)[Wide::kChain]) {
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int x = 0; x < kCnt; ++x)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaSS<Wide::kN, 0, 0>::run(acc, hopper::desc_kmajor(qb[x] + 32 * kk),
                                           hopper::desc_kmajor(kb[x] + 32 * kk), x + kk > 0);
  hopper::wgmma_commit();
  hopper::fence_regs(acc);
}

// O += P V over the kN keys of one key tile's kB V boxes (at shared
// addresses vb[b]: output columns 64 b .. 64 b + 63 of the chunk,
// MN-major), P the bf16 A fragments pa.
template <int kB>
__device__ __forceinline__ void issue_pv_boxes(float (&o)[kB][32], uint32_t (&pa)[Wide::kN / 16][4],
                                               const uint32_t (&vb)[kB]) {
#pragma unroll
  for (int b = 0; b < kB; ++b) hopper::fence_regs(o[b]);
  hopper::fence_regs(pa);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Wide::kN / 16; ++kk)
#pragma unroll
    for (int b = 0; b < kB; ++b)
      hopper::WgmmaRS<64, 1>::run(o[b], pa[kk], hopper::desc_mnmajor(vb[b] + 2048 * kk, Wide::kBox), 1);
  hopper::wgmma_commit();
#pragma unroll
  for (int b = 0; b < kB; ++b) hopper::fence_regs(o[b]);
}

// #1 at any head_dim past kStagedD (the header's design), kB 64-column
// boxes of O a work tile. Block b takes work tiles b, b + gridDim.x, ...
// (wide_tile). Warpgroup 0 is the producer: one thread loads each work
// tile's Q once (resident) and then, per key tile, its nb K boxes (with
// their Q boxes when Q is streamed) and its kB V boxes of the chunk, one
// box a ring slot, each slot with a full and an empty mbarrier.
// Warpgroups 1 .. kWG each own 64 query rows and issue, per key tile j,
// O += P V of tile j - 1 and then S of tile j in fresh chains of kChain
// boxes (chain 0 into s under P V, each later one into u, added to s in
// f32); the softmax of one warpgroup runs under the other's products.
template <int kB>
__global__ void __launch_bounds__(Wide::kThreads, 1)
    flash_fwd_wide_bf16_wgmma_kernel(const Params p, const WideGrid w, const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  using W = Wide;
  constexpr int kN = W::kN, kC = W::kChain;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const int nb = w.nb, ns = w.slots, per = nb + kB;  // boxes of a key tile: nb of K, then kB of V
  const bool resident = w.resident;
  const int slot_bytes = wide_slot(resident);
  bf16* qs = reinterpret_cast<bf16*>(base);                                // resident Q [nb][kM][64]
  unsigned char* ring = base + (resident ? nb * W::kQBox : 0);             // [ns] slots
  const uint32_t qs_a = hopper::smem_u32(qs), ring_a = hopper::smem_u32(ring);  // their shared addresses
  uint64_t* full_q = reinterpret_cast<uint64_t*>(ring + ns * slot_bytes);
  uint64_t* empty_q = full_q + 1;
  uint64_t* full = empty_q + 1;  // [ns]
  uint64_t* empty = full + ns;   // [ns]
  const int tiles = w.nch * w.bh * w.mt;
  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    hopper::mbar_init(empty_q, W::kWG);
    for (int i = 0; i < ns; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], W::kWG);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == 0) {  // the producer warpgroup; one thread issues every load
    hopper::regs_dec<W::kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::prefetch_map(&tq);
      hopper::prefetch_map(&tk);
      hopper::prefetch_map(&tv);
      Slot at{0, 0};
      int qi = 0;  // work tiles loaded so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++qi) {
        const WideTile wt = wide_tile(p, w, t);
        if (resident) {
          if (qi > 0) hopper::mbar_wait(empty_q, (qi - 1) & 1);
          hopper::mbar_expect_tx(full_q, nb * W::kQBox);
          for (int b = 0; b < nb; ++b)
            hopper::tma_load_4d(qs + b * W::kM * 64, &tq, full_q, 64 * b, wt.q0, wt.ih, wt.ib);
        }
#pragma unroll 1
        for (int j = 0; j < wt.n; ++j)
#pragma unroll 1
          for (int x = 0; x < per; ++x, at = slot_at(at, 1, ns)) {
            hopper::mbar_wait(&empty[at.i], at.phase ^ 1);
            unsigned char* dst = ring + at.i * slot_bytes;
            if (x < nb) {  // a K box, and with Q streamed the Q box beside it
              hopper::mbar_expect_tx(&full[at.i], slot_bytes);
              hopper::tma_load_4d(dst, &tk, &full[at.i], 64 * x, j * kN, wt.ih, wt.ib);
              if (!resident) hopper::tma_load_4d(dst + W::kBox, &tq, &full[at.i], 64 * x, wt.q0, wt.ih, wt.ib);
            } else {  // a V box of the chunk (past d: zeros)
              hopper::mbar_expect_tx(&full[at.i], W::kBox);
              hopper::tma_load_4d(dst, &tv, &full[at.i], 64 * (wt.ch * kB + x - nb), j * kN, wt.ih, wt.ib);
            }
          }
      }
    }
  } else {  // a consumer warpgroup
    hopper::regs_inc<W::kConsumerRegs>();
    const int wg = wgi - 1, tid = threadIdx.x & 127;
    const int g = (tid & 31) >> 2, t4 = tid & 3;
    const float c = p.scale * kLog2e;
    const int chains = (nb + kC - 1) / kC;  // at least 2: nb > kC past kStagedD
    // this warpgroup is done with boxes [x0, x1) of the key tile at slot s
    const auto release = [&](Slot s, int x0, int x1) {
      if (tid == 0)
        for (int x = x0; x < x1; ++x) hopper::mbar_arrive(&empty[slot_at(s, x, ns).i]);
    };

    Slot at{0, 0};  // the first box of the key tile in hand
    int qi = 0;     // work tiles consumed so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++qi) {
      const WideTile wt = wide_tile(p, w, t);
      const int n = wt.n;
      const int w0 = wt.q0 + 64 * wg, r0 = w0 + 16 * (tid >> 5) + g;  // this lane's rows r0, r0 + 8
      const auto masked = [&](int k0) { return k0 + kN > p.sk || (p.causal && k0 + kN - 1 > w0); };
      float o[kB][32];
#pragma unroll
      for (int b = 0; b < kB; ++b)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[b][i] = 0.f;
      float s[kN / 2], u[kN / 2];  // S: its first chain, and a later chain in flight
      uint32_t pa[kN / 16][4];
      float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f}, corr[2];
      // S chain ci of the key tile at slot k into acc, once its K boxes
      // (and Q's, streamed) are in
      const auto chain = [&](float(&acc)[kN / 2], Slot k, int ci) {
        const int x0 = kC * ci, cnt = min(kC, nb - x0);
        uint32_t kb[kC], qb[kC];
#pragma unroll
        for (int x = 0; x < kC; ++x) {
          const Slot b = slot_at(k, x0 + x, ns);
          kb[x] = ring_a + b.i * slot_bytes;
          qb[x] = (resident ? qs_a + (x0 + x) * W::kQBox : kb[x] + W::kBox) + 8192 * wg;
          if (x < cnt) hopper::mbar_wait(&full[b.i], b.phase);
        }
        switch (cnt) {
          case 1: issue_chain<1>(acc, qb, kb); break;
          case 2: issue_chain<2>(acc, qb, kb); break;
          case 3: issue_chain<3>(acc, qb, kb); break;
          default: issue_chain<4>(acc, qb, kb); break;
        }
      };
      const auto add_u = [&] {
        hopper::fence_regs(s);
        hopper::fence_regs(u);
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) s[i] += u[i];
      };

      if (resident) hopper::mbar_wait(full_q, qi & 1);
      Slot v_at = at;  // the first V box of key tile j - 1
#pragma unroll 1
      for (int j = 0; j <= n; ++j) {
        int freed = 0;  // K boxes of tile j this warpgroup is done with
        if (j > 0) {  // O += P V of key tile j - 1
          uint32_t vb[kB];
#pragma unroll
          for (int b = 0; b < kB; ++b) {
            const Slot x = slot_at(v_at, b, ns);
            vb[b] = ring_a + x.i * slot_bytes;
            hopper::mbar_wait(&full[x.i], x.phase);
          }
          issue_pv_boxes<kB>(o, pa, vb);
        }
        if (j < n) {  // S of key tile j: chain 0 into s under P V, each later chain into u
          chain(s, at, 0);
#pragma unroll 1
          for (int ci = 1; ci < chains; ++ci) {
            if (ci == 1) {
              hopper::wgmma_wait<1>();  // P V is done: its V boxes and P's registers are free
              if (j > 0) release(v_at, 0, kB);
            } else {
              hopper::wgmma_wait<0>();  // the chain before is done
              add_u();
              release(at, freed, kC * ci);
              freed = kC * ci;
            }
            chain(u, at, ci);
          }
        }
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int b = 0; b < kB; ++b) hopper::fence_regs(o[b]);
        if (j == n) {
          release(v_at, 0, kB);
          continue;
        }
        add_u();
        release(at, freed, nb);
        if (resident && j == n - 1 && tid == 0) hopper::mbar_arrive(empty_q);  // the last product of this Q
        if (masked(j * kN))
          softmax_rows<true, kN>(p, c, r0, j * kN, s, m, l, corr);
        else
          softmax_rows<false, kN>(p, c, r0, j * kN, s, m, l, corr);
#pragma unroll
        for (int b = 0; b < kB; ++b)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[b][i] *= corr[(i >> 1) & 1];
        to_fragments<kN>(s, pa);  // bf16(P) for O += P V; l summed the f32 P
        v_at = slot_at(at, nb, ns);
        at = slot_at(at, per, ns);
      }

      float lnz[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        lnz[i] = fmaxf(l[i], 1e-30f);
      }
      const int c0 = wt.ch * kB * 64;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        store_row<kB * 64>(p.out0 + (((int64_t)wt.ib * p.sq + row) * p.h + wt.ih) * p.d + c0,
                           reinterpret_cast<const float(&)[kB * 32]>(o), half, 1.f / lnz[half], p.d - c0,
                           row < p.sq);
        if (wt.ch == 0 && t4 == 0 && row < p.sq)
          p.lse_out[((int64_t)wt.ib * p.h + wt.ih) * p.sq + row] = (m[half] * c + log2f(lnz[half])) * kLn2;
      }
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

// The body of kernel `kind` at head_dim d up to kStagedD: the wgmma
// bodies at the bucket fwd_dim(d).
void* kernel_of(int kind, int d) {
  static void* const table[3][4] = {
      {(void*)flash_fwd_bf16_wgmma_kernel<64>, (void*)flash_fwd_bf16_wgmma_kernel<128>,
       (void*)flash_fwd_bf16_wgmma_kernel<192>, (void*)flash_fwd_bf16_wgmma_kernel<256>},
      {(void*)flash_dq_bf16_wgmma_kernel<64>, (void*)flash_dq_bf16_wgmma_kernel<128>,
       (void*)flash_dq_bf16_wgmma_kernel<192>, (void*)flash_dq_bf16_wgmma_kernel<256>},
      {(void*)flash_dkv_bf16_wgmma_kernel<64>, (void*)flash_dkv_bf16_wgmma_kernel<128>,
       (void*)flash_dkv_bf16_wgmma_kernel<192>, (void*)flash_dkv_bf16_wgmma_kernel<256>}};
  return table[kind][fwd_dim(d) / 64 - 1];
}

// the wide forward's instantiation at kB boxes an output chunk
void* wide_kernel(int kb) {
  static void* const table[3] = {
      (void*)flash_fwd_wide_bf16_wgmma_kernel<2>, (void*)flash_fwd_wide_bf16_wgmma_kernel<3>,
      (void*)flash_fwd_wide_bf16_wgmma_kernel<4>};
  return table[kb - 2];
}

// Boxes kB of an output chunk of the wide forward at head_dim d (nb
// boxes), on a grid of `tiles` query tiles ((b h) x 128-row tiles) over
// `sms` SMs, one block an SM: the kB of 2 .. Wide::kMaxBoxes with the
// least work on the busiest SM, waves x (nb + kB) box products (every
// chunk computes the scores again), the widest on a tie.
int wide_boxes(int tiles, int d, int sms) {
  const int nb = (d + 63) / 64;
  int best = Wide::kMaxBoxes;
  long long cost = -1;
  for (int kb = Wide::kMaxBoxes; kb >= 2; --kb) {
    const long long waves = ((long long)tiles * ((nb + kb - 1) / kb) + sms - 1) / sms;
    if (cost < 0 || waves * (nb + kb) < cost) best = kb, cost = waves * (nb + kb);
  }
  return best;
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

// bytes of dynamic shared memory of kernel `kind` at head_dim d up to kStagedD
size_t smem_bytes(int kind, int d) {
  return kind == kFwd ? smem_of<Fwd>(d) : kind == kDq ? smem_of<Dq>(d) : smem_of<Dkv>(d);
}

// Sets a kernel's shared-memory cap once: `bytes`. slot: 0-3 the
// bucket of fwd_dim up to kStagedD, 2 + kB the wide forward's kB.
int configure(int kind, int slot, void* fn, int bytes) {
  static bool configured[3][8] = {};
  if (configured[kind][slot]) return 0;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  configured[kind][slot] = true;
  return 0;
}

// configure() for kernel `kind` at head_dim d up to kStagedD
int configure_staged(int kind, int d) {
  return configure(kind, fwd_dim(d) / 64 - 1, kernel_of(kind, d), (int)smem_bytes(kind, d));
}

// configure() for the wide forward at kB boxes a chunk: all a block may
// take (the resident Q tile and the ring share it)
int configure_wide(int kb) { return configure(kFwd, 2 + kb, wide_kernel(kb), kSmemMax); }

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

template <int kB>
int launch_wide_at(const Params& p, const WideGrid& w, const CUtensorMap* maps, cudaStream_t stream) {
  const int grid = min(w.nch * w.bh * w.mt, sm_count());  // persistent: one block an SM
  flash_fwd_wide_bf16_wgmma_kernel<kB><<<grid, Wide::kThreads, wide_bytes(w.nb), stream>>>(p, w, maps[0], maps[1],
                                                                                          maps[2]);
  return (int)cudaGetLastError();
}

// #1 past kStagedD: the grid of work tiles and the ring (the header's design)
int launch_wide(const Params& p, int b, cudaStream_t stream) {
  WideGrid w;
  w.bh = b * p.h;
  w.mt = (p.sq + Wide::kM - 1) / Wide::kM;
  w.nb = (p.d + 63) / 64;
  const int kb = wide_boxes(w.bh * w.mt, p.d, sm_count());
  w.nch = (w.nb + kb - 1) / kb;
  w.resident = wide_resident(w.nb);
  w.slots = wide_slots(w.nb, w.resident);
  int e = configure_wide(kb);
  CUtensorMap maps[3];
  if (!e) e = encode_operands(p, b, Wide::kM, Wide::kN, 3, maps);
  if (e) return e;
  switch (kb) {
    case 2: return launch_wide_at<2>(p, w, maps, stream);
    case 3: return launch_wide_at<3>(p, w, maps, stream);
    default: return launch_wide_at<4>(p, w, maps, stream);
  }
}

int launch(int kind, const Params& p, int b, cudaStream_t stream) {
  if (!takes(kind, p.d)) return (int)cudaErrorInvalidValue;
  if (p.d > kStagedD) return launch_wide(p, b, stream);
  const int err = configure_staged(kind, p.d);
  if (err) return err;
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

}  // namespace

extern "C" {

const char* ff_flash_bf16_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// What one block of kernel `kind` (0 forward, 1 dQ, 2 dK/dV) at head_dim d
// takes and how many fit an SM: out = {registers per thread, local (spill)
// bytes per thread, dynamic shared bytes, threads, blocks per SM}. Past
// kStagedD the forward's instantiation at `boxes` (2 .. Wide::kMaxBoxes)
// boxes an output chunk, or at 0 the one a grid of many waves runs.
int ff_flash_bf16_occupancy(int kind, int d, int boxes, int* out) {
  if (kind < kFwd || kind > kDkv || !takes(kind, d)) return (int)cudaErrorInvalidValue;
  if (d > kStagedD) {
    if (boxes != 0 && (boxes < 2 || boxes > Wide::kMaxBoxes)) return (int)cudaErrorInvalidValue;
    const int kb = boxes ? boxes : wide_boxes(1 << 20, d, sm_count());
    const int err = configure_wide(kb);
    if (err) return err;
    return flash::occupancy(wide_kernel(kb), wide_bytes((d + 63) / 64), out, Wide::kThreads);
  }
  const int err = configure_staged(kind, d);
  if (err) return err;
  return flash::occupancy(kernel_of(kind, d), smem_bytes(kind, d), out, Fwd<64>::kThreads);
}

// The boxes an output chunk of the wide forward (head_dim d past kStagedD)
// takes for q [b, sq, h, d] on the current card: the instantiation
// ff_flash_fwd_bf16 launches there.
int ff_flash_bf16_wide_boxes(int b, int h, int sq, int d) {
  if (!takes(kFwd, d) || d <= kStagedD || b <= 0 || h <= 0 || sq <= 0) return 0;
  return wide_boxes(b * h * ((sq + Wide::kM - 1) / Wide::kM), d, sm_count());
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
  return launch(kFwd, p, b, (cudaStream_t)stream);
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
  return launch(kDq, p, b, (cudaStream_t)stream);
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
  return launch(kDkv, p, b, (cudaStream_t)stream);
}

}  // extern "C"
