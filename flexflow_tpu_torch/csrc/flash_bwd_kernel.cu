// Flash attention backward for Hopper (sm_90a), fp32 in and out, products on
// the tensor cores in 3xTF32: the device body of kernels #2 and #3. Built by
// flexflow_tpu_torch/ops/cuda/_build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes by
// flexflow_tpu_torch/ops/cuda/flash_kernel.py. The helpers it shares with
// the forward (#1, csrc/flash_kernel.cu) are in csrc/flash_common.cuh.
//
// What it replaces: two Pallas TPU kernels of
// flexflow_tpu/ops/pallas/flash_kernel.py —
//   * flash_dq_tf32_kernel replaces _dq_kernel (:230, pallas_call :384):
//     dQ = sum over key tiles of dS K, dS = P * (dO V^T - delta) * scale,
//     P = exp(Q K^T * scale - LSE);
//   * flash_dkv_tf32_kernel (and flash_dkv_mma_kernel at head_dim 72-128)
//     replaces _dkv_kernel (:269, pallas_call :419): dV = sum over query
//     tiles of P^T dO and dK = dS^T Q.
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
// a b ~ small_a big_b + big_a small_b + big_a big_b, accumulated in fp32
// (error ~2^-21 per product; one TF32 pass alone is ~2^-11).
//
// Up to head_dim 128 (flash_dq_tf32_kernel, flash_dkv_tf32_kernel: one
// body, tf32_body, below) every product is .tf32 wgmma, issued by a
// consumer warpgroup of 64 fixed rows over tiles that TMA loads:
//   * The tensor cores ignore the 13 low bits of a .tf32 operand, so the
//     raw fp32 tile TMA delivers is already big; only small = (x - big)
//     plus half a TF32 ulp needs a copy, written once per staged tile (the
//     fixed tile once a block, each loop tile once a ring slot) by the
//     producer warpgroups' warps, in the same swizzled layout, not once
//     per fragment read by every warp as the mma.sync body split them.
//   * The score products (S = Q K^T and dP = dO V^T in #2; S^T = K Q^T
//     and dP^T = V dO^T in #3) contract over head_dim, which is contiguous
//     in every [b, s, h, d] operand, so both operands are K-major as TMA
//     stores them (32-column boxes, 128-byte swizzle, hopper.cuh): three
//     passes, small·big, big·small, big·big, at each k8 step, both
//     operands from shared memory, N = the loop tile's 32 rows.
//   * The output products (dQ += dS K, dV += P^T dO, dK += dS^T Q)
//     contract over a tile's rows, which .tf32 wgmma cannot read (no
//     transpose bit). The split also writes the loop operand transposed,
//     big and small, each 8-row group in the order the A fragment's k
//     slots take it, so that dS and P feed the products from registers as
//     the accumulators hold them (RS, N = the bucket's head_dim).
//   * A's accumulator layout is mma.sync's m16n8 fragment layout, so the
//     masks, exponentials and dS are the mma.sync body's.
//   * A producer warp's one thread keeps TMA loads of the loop tiles in
//     flight (a ring of kS slots, full, ready and empty mbarriers a slot;
//     #3's LSE and delta as flat boxes with the tile), and 7 more warps of
//     two producer warpgroups write the small copies and transposes
//     (setmaxnreg gives their registers to the consumers).
//   * Accuracy: the tensor cores round each k8 step's sum into the
//     accumulator toward zero, so a chain drifts with its length and with
//     what it holds when each term comes. The score products keep the
//     small terms in a chain apart from big·big, added in fp32 once done;
//     at a key seen by 300 queries that keeps dK/dV at 0.33 of the
//     gradient gate against float64 at head_dim 64, where the three passes
//     of each k8 step in turn reached 0.72 (a CPU model,
//     tests/test_torch_flash_kernel.py).
// The block of each kernel and bucket (Tf32Cfg; DqB0 .. DqB2 below) is
// what measured fastest (scripts/flash_bwd_tf32_variants.py; H100 80GB
// HBM3, 700 W, the profiler's device time, fresh processes in turns): at
// [8, 512, 16, 64] the pair takes 0.419-0.430 ms against the mma.sync
// body's 0.664-0.667 (causal 0.303-0.310 against 0.479-0.492), and
// 0.452-0.457 against 0.730-0.738 at [8, 512, 32, 32]. Measured and taken
// out at [8, 512, 16, 64]: the output products on mma.sync (the score
// products alone on wgmma, the next tile's issued before this one's
// pass) 0.707-0.713; 3 split warps in place of 7 0.449-0.463; dK/dV with
// two consumer warpgroups and one slot 0.488-0.490 (48 bytes of spills,
// wgmma serialized, C7512). Without the copies the pair would take
// 0.378-0.391, without the split 0.376: both are partly exposed with the
// 2 slots that shared memory holds beside the fixed tile. At head_dim
// 72-128 the fixed tile alone takes 128 KB (raw and small), and #3's slot
// of transposes 128 KB more, so #3 there stays on the 3xTF32 mma.sync
// body (flash_dkv_mma_kernel<16>: 4 warps over 64 keys and 32-row query
// tiles staged by cp.async, each operand split per fragment read; its
// score products take the small terms of every k-step first, product_nt
// says why, at 0.678-0.722 ms against 0.611-0.619 without at [8, 512, 8,
// 128]; its tf32 body with the output products on mma.sync took 18%
// more), while #2 runs its tf32 body with one ring slot: 0.252-0.259
// against the mma.sync body's 0.460-0.462.
//
// Past head_dim 128 (any multiple of 8) flash_dq_wide_kernel and
// flash_dkv_wide_kernel compute the scores once per tile pair, over 8
// consumer warps that hold all of a block's output columns, with the loop
// operand streamed in 128-column pieces through a TMA ring that a
// producer warpgroup keeps full (see them below). bf16 past head_dim 256
// runs the design they replaced (flash_dq_wide_bf16_kernel,
// flash_dkv_wide_bf16_kernel: the same roles, with every thread copying
// the pieces into a cp.async-style ring of 2 slots).

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

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

// -- dK, dV at head_dim 72-128: the 3xTF32 mma.sync body ------------------------------

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
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_mma_kernel(const Params p) {
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
    const int q0 = q_start + it * kLoop, cb = it & 1;
    const float* qt = qs + cb * tile;
    const float* gt = gs + cb * tile;
    float s[kNT][4], dp[kNT][4];
    zero<kNT>(s);
    zero<kNT>(dp);
    product_nt<kDT, kNT>(kw, qt, s, vw, gt, dp, dt);  // S^T = K Q^T, dP^T = V dO^T
    const bool all = q0 + kLoop <= p.sq && w0 + 16 <= p.sk && (!p.causal || q0 >= w0 + 15);
    if (all)
      ds_cols<false>(p, r0, q0, ls + cb * kLoop, dls + cb * kLoop, s, dp);
    else
      ds_cols<true>(p, r0, q0, ls + cb * kLoop, dls + cb * kLoop, s, dp);
    // dV += P^T dO, dK += dS^T Q
    product_pn<kDT, kNT, 1>(s, gt, dv, dp, qt, dk, dt);
  }
  cp_async_wait_all();  // nothing in flight when the block exits
  store_rows<kDT>(p.out0, ib, ih, p.h, p.sk, r0, d, dt, dk);
  store_rows<kDT>(p.out1, ib, ih, p.h, p.sk, r0, d, dt, dv);
}

// -- fp32 past kMmaMaxD: flash_dq_wide_kernel, flash_dkv_wide_kernel -------------------
// One body (wide_body) runs both, naming its operands by role. The fixed
// tile X (dQ: Q and dO; dK/dV: K and V) is kWideRows rows of one block;
// the loop tiles Y (dQ: K and V; dK/dV: Q and dO) are kWideRows rows each.
// For each loop tile:
//   scores  S = X0 Y0^T and dP = X1 Y1^T over the whole head_dim, once;
//   P, dS   P = exp(S scale - LSE) and dS = P (dP - delta) scale, masked;
//   outputs dQ += dS Y0, or dK += dS^T Y0 and dV += P^T Y1 (there the
//           scores are S^T and dP^T, so the same code reads them
//           transposed).
// At [8, 512, 4, 320] the pair does 7 products of depth 320 over 8.4 M
// (query, key) pairs, 113 GFLOP of TF32 mma's in 3xTF32, against 84 MB of
// operands: operations bound it. The block: two consumer warpgroups (8
// warps) and a producer warpgroup, one block an SM.
//   * The scores once per tile pair: the 8 consumer warps hold all of the
//     block's output columns (at most kWideChunkTiles n-tiles a block:
//     past 512 columns grid z cuts chunks, each computing the scores
//     again). The score products are split over the warps by product (S
//     or dP) and quarter of each piece's k-steps, each warp over both
//     16-row m-tiles, so a B fragment of Y is split once for two mma's
//     (split by 16-row m-tile and half of the k-steps, the pair took 5-6%
//     more time); each warp writes its partial fragments to shared memory
//     as they stand, and one pass sums the quarters. The warp of each
//     fragment (m-tile, n-tile) is the only reader of its partials, so it
//     writes dS (and P) over them as split 3xTF32 A fragments (put_a).
//     dQ's output n-tiles go to the 8 warps round-robin (warp w owns
//     n-tiles 8u + w), dK's to warps 0-3 and dV's to warps 4-7 (4u + w),
//     each over both m-tiles. A warp reads the A fragments of its operand
//     (dS or P) once a loop tile, with 16-byte loads, and holds them in
//     registers (64) through the tile's output pieces (read once a piece
//     by every warp for both operands: 2% more time at [8, 512, 4, 320]).
//     32 fixed rows keep a warp's dK or dV within 128 registers at 512
//     columns and give 128 blocks at [8, 256, 2, 512].
//   * Copies under the products, none issued by the consumers: the loop
//     tile's pieces (128 columns: four TMA boxes of 32 fp32 columns x 32
//     rows, 128-byte swizzled) stream through a ring of mbarrier slots,
//     as many as shared memory leaves (up to kMaxStages), kept full by one
//     thread of the producer warpgroup. Per loop tile the items are its
//     head_dim pieces of Y0 and Y1 for the scores, then the pieces of the
//     block's output columns of Y0 (and Y1 for dK/dV). A box past the
//     tensor's rows or columns arrives zero-filled, so a ragged edge needs
//     no test in the copy. In the swizzle every fragment read is free of
//     bank conflicts (the score products' B: row g, column 8 ks + t (+4);
//     the output products' B: row 2t (+1), column 8j + g).
//   * The fixed tile staged once: X0 and X1 stay resident for the whole
//     loop as unsplit A fragments (32 d floats each, one 16-byte read a
//     fragment) up to kWideResidentD, the widest that leaves room for 2
//     ring slots; past it their pieces ride in the ring beside Y's.
//   * Three named barriers of the consumer warps a loop tile (the last
//     tile's A fragments are read; the score partials are in; dS and P are
//     in); the ring runs on mbarriers (full: the producer's bytes; empty:
//     one arrival per consumer warp).
//   * Registers: the producer warpgroup gives its registers up
//     (setmaxnreg), so a consumer thread holds 240: dK and dV's 128
//     accumulators beside the score chains without spilling. Nine warps (a
//     producer warp) would cap a thread at 168.
// A warp's score products take a fresh accumulator per piece (at most 4
// k-steps, 12 mma's a chain), added in fp32; the output products chain
// over the loop tiles into one accumulator, as #3's always did. dQ's
// consumers read LSE and delta of their pass rows once with plain loads;
// dK/dV's producer loads each loop tile's rows (flat TMA boxes) with its
// first item: even in time with plain loads by the consumers at the top
// of each tile, which left 12 bytes of spills in the streamed dK/dV.
// On an H100 (700 W) the pair takes 0.927-0.943 / 0.757-0.765 /
// 0.193-0.197 ms of device time at [8, 512, 4, 320] / [8, 512, 4, 256] /
// [8, 256, 2, 512] (causal at 320: 0.664-0.675), where the body it
// replaced (the same roles, every thread copying the pieces by cp.async
// into a ring of 2 slots, one block barrier an item) took 1.259-1.273 /
// 0.960-0.967 / 0.249-0.251 (0.862-0.879) and SDPA's backward takes
// 0.887-0.903 / 0.685-0.703 / 0.327-0.335 (0.762-0.782). Its copies are
// hidden (left out, the pair takes the same time; a ring of 2 slots
// costs 0-2%; cp.async in place of TMA 2.5x), and the hand-offs between
// the phases (the three named barriers) cost 4-6%; the rest is the
// mma.sync products, the pair at 37% of the card's 322.5 TFLOP/s TF32
// mma.sync rate at 320 (scripts/flash_bwd_fp32_variants.py times the
// ablations).

constexpr int kWideRows = 32;  // rows of the fixed tile and of a loop tile
constexpr int kWideWarps = 8;  // consumer warps
constexpr int kWideOT = 8;     // output n-tiles of a warp of the bf16 body (both of its outputs)
constexpr int kWideChunkTiles = kWideWarps * kWideOT;  // output n-tiles of a block
constexpr int kSmemMax = 232448;                       // dynamic shared memory one block may take
// widest head_dim whose fixed tile stays resident (asserted below for
// each wide body)
constexpr int kWideResidentD = 512;

constexpr int kWideThreads = 128 * 3;  // two consumer warpgroups and a producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBox = 32 * 32;       // floats of a box: 32 rows of 32 columns (128 bytes)
constexpr int kPieceBoxes = 4;      // boxes of one operand's piece: 128 columns
constexpr int kPieceCols = 32 * kPieceBoxes;
constexpr int kPieceSteps = kPieceCols / 8;  // k-steps of a score piece, n-tiles of an output piece
constexpr int kMaxStages = 8;                // ring slots: as many as shared memory leaves, at most this
// dK/dV: LSE and delta of a loop tile's 32 queries in one flat TMA box each,
// from the 16-byte boundary at or before the tile's first query (a box
// that starts between raises an illegal instruction); 64 floats apart
constexpr int kRowBox = 36;
constexpr int kRowBufs = 2 * 2 * 64;  // floats of the row buffers: [loop tile parity][LSE, delta][64]

// Floats of a ring slot: pieces of Y0 and Y1, and of X0 and X1 when the
// fixed tile is streamed.
__host__ __device__ constexpr int wide_slot(bool resident) { return (resident ? 2 : 4) * kPieceBoxes * kBox; }

// Fragment slot (product, k-quarter, m-tile, n-tile) of the score
// partials; after the pass the warp of (m-tile, n-tile) keeps there its A
// fragments of the output products: dS (product 0) and P (product 1), big
// (quarter 0) and small (quarter 1) parts.
__host__ __device__ constexpr int part_slot(int prod, int kq, int mt, int j) {
  return ((prod * 4 + kq) * 2 + mt) * 4 + j;
}

// Shared bytes of the wide body besides its ring: the score partials (64
// fragments), the resident X0 and X1 (dt k-steps x 2 m-tiles of unsplit A
// fragments each: 64 d floats), dK/dV's LSE and delta rows of two loop
// tiles, the mbarriers, and 1024 bytes to align the ring to the swizzle's
// period.
__host__ __device__ constexpr int wide_fixed(int d, bool resident) {
  return 4 * (64 * kFrag + (resident ? 64 * d : 0) + kRowBufs) + 16 * kMaxStages + 1024;
}

// Ring slots at head_dim d: what shared memory leaves, at most kMaxStages.
__host__ __device__ constexpr int wide_stages(int d, bool resident) {
  return (kSmemMax - wide_fixed(d, resident)) / (4 * wide_slot(resident)) < kMaxStages
             ? (kSmemMax - wide_fixed(d, resident)) / (4 * wide_slot(resident))
             : kMaxStages;
}

__host__ __device__ constexpr int wide_bytes(int d, bool resident) {
  return wide_fixed(d, resident) + 4 * wide_stages(d, resident) * wide_slot(resident);
}

static_assert(wide_stages(kWideResidentD, true) >= 2 && wide_stages(kWideResidentD + 8, true) < 2,
              "kWideResidentD is the widest fixed tile that stays resident beside 2 ring slots");
static_assert(wide_stages(0, false) >= 2, "the streamed body holds 2 ring slots");
// dK/dV's row buffers: the producer rewrites a tile's buffer two tiles on,
// once item (it + 2) (kp + op) - stages is free, past the tile's kp score
// items when stages <= kp + 2 op; that is 6 at the narrowest wide head_dim
// (2 + 2 2), which has the most slots, and more past it
static_assert(wide_stages(136, true) <= 6 && wide_stages(0, false) <= 5 + 2 * 3,
              "dK/dV's pass reads a loop tile's rows before the producer loads those of tile it + 2 over them");

// s[m][j] += X_m Y_j^T over k-steps [k0, k1) of a ring piece (at most
// kPieceSteps / 4), into a fresh accumulator: both m-tiles of X
// (resident: xf at the piece's first k-step, fragments [k-step][m-tile];
// streamed: the piece's boxes xb) against the piece's boxes yb, each B
// fragment split once for the two m-tiles.
template <bool kResident>
__device__ __forceinline__ void score_piece(const float* xf, const float* xb, const float* yb, int k0, int k1,
                                            float s[2][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float f[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) zero<4>(f[m]);
#pragma unroll
  for (int u = 0; u < kPieceSteps / 4; ++u) {
    const int kk = k0 + u;
    if (kk < k1) {
      const int bx = kk >> 2, cc = 8 * (kk & 3) + t;  // box, and the lane's column in it
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float a[4];
        if constexpr (kResident) {
          const float4 x = *reinterpret_cast<const float4*>(xf + (2 * kk + m) * kFrag + 4 * lane);
          a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
        } else {
          const float* xt = xb + bx * kBox;
          a[0] = xt[swz(16 * m + g, cc)], a[1] = xt[swz(16 * m + g + 8, cc)];
          a[2] = xt[swz(16 * m + g, cc + 4)], a[3] = xt[swz(16 * m + g + 8, cc + 4)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) split(a[i], ab[m][i], as[m][i]);
      }
      const float* yt = yb + bx * kBox;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bb[2], bs[2];
        split(yt[swz(8 * j + g, cc)], bb[0], bs[0]);
        split(yt[swz(8 * j + g, cc + 4)], bb[1], bs[1]);
#pragma unroll
        for (int m = 0; m < 2; ++m) mma3_split(f[m][j], ab[m], as[m], bb, bs);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[m][j][e] += f[m][j][e];
}

// The fp32 wide body of dQ (kDkv false) or dK/dV (the section's header).
// Grid: (fixed tiles of kWideRows rows, b h, output chunks of at most
// kWideChunkTiles n-tiles). Tensor maps of the fixed (tx0, tx1) and loop
// (ty0, ty1) operands, boxes of 32 columns x kWideRows rows, and flat ones
// of LSE and delta (tl, td; read by dK/dV), boxes of kRowBox values.
template <bool kDkv, bool kResident>
__device__ __forceinline__ void wide_body(const Params& p, const CUtensorMap* tx0, const CUtensorMap* tx1,
                                          const CUtensorMap* ty0, const CUtensorMap* ty1, const CUtensorMap* tl,
                                          const CUtensorMap* td) {
  constexpr int kR = kWideRows, kOps = kDkv ? 2 : 1;
  constexpr int kSlot = wide_slot(kResident);
  const int d = p.d, dt = d / 8;
  const int stages = wide_stages(d, kResident);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));
  float* part = ring + stages * kSlot;  // score partials, then A fragments (part_slot)
  float* xf = part + 64 * kFrag;        // resident X0, X1: [operand][k-step][m-tile] A fragments
  float* rows = xf + (kResident ? 64 * d : 0);  // dK/dV: [loop tile parity][LSE, delta][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + kRowBufs);
  uint64_t* empty = full + kMaxStages;
  int c0t, cn;  // this block's output columns: n-tiles [c0t, c0t + cn)
  z_chunk(dt, c0t, cn);
  const int c0 = 8 * c0t;
  const int f0 = blockIdx.x * kR, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int xrows = kDkv ? p.sk : p.sq;
  // loop tiles [l_start, l_start + n kR): dQ's stop at the causal
  // diagonal, dK/dV's start there
  int l_start = 0, n;
  if constexpr (kDkv) {
    l_start = p.causal ? f0 : 0;
    n = p.sq > l_start ? (p.sq - l_start + kR - 1) / kR : 0;
  } else {
    n = ((p.causal ? min(p.sk, f0 + kR) : p.sk) + kR - 1) / kR;
  }
  const int kp = (d + kPieceCols - 1) / kPieceCols;       // score pieces a loop tile
  const int op = (8 * cn + kPieceCols - 1) / kPieceCols;  // output pieces a loop tile
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], kWideWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 32 * kWideWarps) {  // the producer warpgroup: one thread loads every piece
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x != 32 * kWideWarps) return;
    hopper::prefetch_map(ty0);
    hopper::prefetch_map(ty1);
    if (kDkv) {
      hopper::prefetch_map(tl);
      hopper::prefetch_map(td);
    }
    if (!kResident) {
      hopper::prefetch_map(tx0);
      hopper::prefetch_map(tx1);
    }
    int slot = 0, phase = 0;  // of the next item
    for (int it = 0; it < n; ++it) {
      const int l0 = l_start + it * kR;
      for (int r = 0; r < kp + op; ++r) {
        const bool score = r < kp;
        const int col = score ? r * kPieceCols : c0 + (r - kp) * kPieceCols;
        const int boxes = min(kPieceBoxes, ((score ? d : c0 + 8 * cn) - col + 31) / 32);
        const int pieces = score ? (kResident ? 2 : 4) : kOps;  // operands' pieces of the item
        float* dst = ring + slot * kSlot;
        hopper::mbar_wait(&empty[slot], phase ^ 1);
        // a box past the tensor's rows or columns arrives zero-filled; the
        // tile's LSE and delta rows ride with its first item, into the
        // buffer of tile it - 2, whose pass read it before arriving on
        // that tile's output items (asserted below)
        const bool with_rows = kDkv && r == 0;
        hopper::mbar_expect_tx(&full[slot], pieces * boxes * kBox * 4 + (with_rows ? 2 * kRowBox * 4 : 0));
        if (with_rows) {
          const int r0 = (int)((((int64_t)ib * p.h + ih) * p.sq + l0) & ~3ll);
          hopper::tma_load_1d(rows + (it & 1) * 128, tl, &full[slot], r0);
          hopper::tma_load_1d(rows + (it & 1) * 128 + 64, td, &full[slot], r0);
        }
        for (int b = 0; b < boxes; ++b) {
          const int cb = col + 32 * b;
          hopper::tma_load_4d(dst + b * kBox, ty0, &full[slot], cb, l0, ih, ib);
          if (score || kDkv) hopper::tma_load_4d(dst + (kPieceBoxes + b) * kBox, ty1, &full[slot], cb, l0, ih, ib);
          if (score && !kResident) {
            hopper::tma_load_4d(dst + (2 * kPieceBoxes + b) * kBox, tx0, &full[slot], cb, f0, ih, ib);
            hopper::tma_load_4d(dst + (3 * kPieceBoxes + b) * kBox, tx1, &full[slot], cb, f0, ih, ib);
          }
        }
        if (++slot == stages) slot = 0, phase ^= 1;
      }
    }
    return;
  }
  hopper::regs_inc<kConsumerRegs>();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (kResident) {
    // X0 and X1 once, unsplit: element (r, c) is A-fragment slot (r / 8) %
    // 2 + 2 ((c % 8) / 4) of lane (r % 8, c % 4) in fragment (k-step c / 8,
    // m-tile r / 16); kU 16-byte loads of a thread in flight at once
    constexpr int kU = 8;
    const float* x0 = kDkv ? p.k + ib * p.k_sb + ih * p.k_sh : p.q + ib * p.q_sb + ih * p.q_sh;
    const float* x1 = kDkv ? p.v + ib * p.v_sb + ih * p.v_sh : p.dout + ib * p.g_sb + ih * p.g_sh;
    const int64_t s0 = kDkv ? p.k_ss : p.q_ss, s1 = kDkv ? p.v_ss : p.g_ss;
    const int d4 = d / 4, per = kR * d4;
    for (int i0 = threadIdx.x; i0 < 2 * per; i0 += kU * 32 * kWideWarps) {
      float4 v[kU];
      float* f[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * 32 * kWideWarps;
        const int o = i >= per, j = i - o * per, r = j / d4, c = 4 * (j - r * d4);
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        f[u] = i < 2 * per ? xf + o * 32 * d + ((c >> 3) * 2 + (r >> 4)) * kFrag + 16 * (r & 7) + ((r >> 3) & 1) +
                                 2 * ((c >> 2) & 1)
                           : nullptr;
        if (i < 2 * per && f0 + r < xrows)
          v[u] = __ldg(reinterpret_cast<const float4*>((o ? x1 : x0) + (int64_t)(f0 + r) * (o ? s1 : s0) + c));
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (f[u] != nullptr) f[u][0] = v[u].x, f[u][4] = v[u].y, f[u][8] = v[u].z, f[u][12] = v[u].w;
    }
    hopper::bar_sync(1, 32 * kWideWarps);
  }

  // score role: product (0 S, 1 dP) and quarter of each piece's k-steps,
  // over both m-tiles
  const int prod = warp >> 2, kq = warp & 3;
  // pass role: the scores' fragment (m-tile pmt, n-tile pj)
  const int pmt = warp >> 2, pj = warp & 3;
  float lse[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // dQ: of the pass rows, read once
  if constexpr (!kDkv) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = f0 + 16 * pmt + g + 8 * i;
      const int64_t off = ((int64_t)ib * p.h + ih) * p.sq + r;
      lse[i] = r < p.sq ? p.lse[off] : 0.f;
      dl[i] = r < p.sq ? p.delta[off] : 0.f;
    }
  }

  // output role: the operand (dK/dV: 0 for dS, Y0 and dK, 1 for P, Y1 and
  // dV; dQ: 0) and the warp's place among the kOW warps that share it
  constexpr int kOW = kDkv ? kWideWarps / 2 : kWideWarps;
  constexpr int kOT = kWideChunkTiles / kOW;  // output n-tiles of a warp
  const int oo = warp / kOW, ow = warp % kOW;
  float acc[2][kOT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) zero<kOT>(acc[m]);
  float4* const part4 = reinterpret_cast<float4*>(part) + lane;
  int slot = 0, phase = 0;  // of the next item
  for (int it = 0; it < n; ++it) {
    const int l0 = l_start + it * kR;
    float s[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) zero<4>(s[m]);
    for (int pc = 0; pc < kp; ++pc) {
      const float* sl = ring + slot * kSlot;
      const int ks = min(kPieceSteps, dt - pc * kPieceSteps);
      const float* xr = xf + prod * 32 * d + pc * kPieceSteps * 2 * kFrag;
      const float* xb = sl + (2 + prod) * kPieceBoxes * kBox;
      const float* yb = sl + prod * kPieceBoxes * kBox;
      hopper::mbar_wait(&full[slot], phase);
      score_piece<kResident>(xr, xb, yb, kq * ks / 4, (kq + 1) * ks / 4, s);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[slot]);
      if (++slot == stages) slot = 0, phase ^= 1;
    }
    hopper::bar_sync(1, 32 * kWideWarps);  // every warp is done with the last tile's A fragments
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part4[32 * part_slot(prod, kq, m, j)] = make_float4(s[m][j][0], s[m][j][1], s[m][j][2], s[m][j][3]);
    hopper::bar_sync(1, 32 * kWideWarps);  // the partials are in
    {
      // this thread's 4 scores: S and dP summed over the k-quarters
      float sv[4] = {0.f, 0.f, 0.f, 0.f}, dv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 x = part4[32 * part_slot(0, q, pmt, pj)], y = part4[32 * part_slot(1, q, pmt, pj)];
        sv[0] += x.x, sv[1] += x.y, sv[2] += x.z, sv[3] += x.w;
        dv[0] += y.x, dv[1] += y.y, dv[2] += y.z, dv[3] += y.w;
      }
      // dK/dV: LSE and delta of the pass columns' queries, in the rows that
      // came with the tile's first item (queries past sq are masked)
      const float* lb = rows + (it & 1) * 128 + (int)((((int64_t)ib * p.h + ih) * p.sq + l0) & 3) + 8 * pj + 2 * t;
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int fr = f0 + 16 * pmt + g + 8 * (e >> 1), lr = l0 + 8 * pj + 2 * t + (e & 1);
        const bool ok = kDkv ? visible(p, lr, fr) : visible(p, fr, lr);
        const float ls = kDkv ? lb[e & 1] : lse[e >> 1], de = kDkv ? lb[64 + (e & 1)] : dl[e >> 1];
        pv[e] = ok ? expf(sv[e] * p.scale - ls) : 0.f;
        dsv[e] = pv[e] * (dv[e] - de) * p.scale;
      }
      // into this warp's own partial slots, which no other warp reads
      float* fa = part + 4 * lane;
      put_a<false>(fa + part_slot(0, 0, pmt, pj) * kFrag, fa + part_slot(0, 1, pmt, pj) * kFrag, dsv);
      if constexpr (kDkv)
        put_a<false>(fa + part_slot(1, 0, pmt, pj) * kFrag, fa + part_slot(1, 1, pmt, pj) * kFrag, pv);
    }
    hopper::bar_sync(1, 32 * kWideWarps);  // dS (and P) are in
    // the A fragments of the warp's operand for the whole loop tile, held
    // in registers through its output pieces
    uint32_t ab[kR / 8][2][4], as[kR / 8][2][4];
#pragma unroll
    for (int kk = 0; kk < kR / 8; ++kk)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* fa = part + 4 * lane;
        get_a<false>(fa + part_slot(oo, 0, m, kk) * kFrag, fa + part_slot(oo, 1, m, kk) * kFrag, ab[kk][m],
                     as[kk][m]);
      }
#pragma unroll
    for (int pc = 0; pc < kWideChunkTiles / kPieceSteps; ++pc) {
      if (pc < op) {
        const float* sl = ring + slot * kSlot;
        hopper::mbar_wait(&full[slot], phase);
#pragma unroll
        for (int kk = 0; kk < kR / 8; ++kk) {
#pragma unroll
          for (int i = 0; i < kPieceSteps / kOW; ++i) {
            const int nt = kOW * i + ow;  // the warp's n-tile of the piece
            if (kPieceSteps * pc + nt < cn) {
              // B: rows 8 kk + 2t (+1) of the piece of the warp's operand,
              // the lane's column of the n-tile
              const float* yb = sl + (oo * kPieceBoxes + (nt >> 2)) * kBox;
              const int cc = 8 * (nt & 3) + g;
              uint32_t bb[2], bs[2];
              split(yb[swz(8 * kk + 2 * t, cc)], bb[0], bs[0]);
              split(yb[swz(8 * kk + 2 * t + 1, cc)], bb[1], bs[1]);
#pragma unroll
              for (int m = 0; m < 2; ++m)
                mma3_split(acc[m][kPieceSteps / kOW * pc + i], ab[kk][m], as[kk][m], bb, bs);
            }
          }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[slot]);
        if (++slot == stages) slot = 0, phase ^= 1;
      }
    }
  }
  const int mine = (cn - ow + kOW - 1) / kOW;  // this warp's n-tiles kOW u + ow below cn
  float* out = (oo ? p.out1 : p.out0) + c0 + 8 * ow;
#pragma unroll
  for (int m = 0; m < 2; ++m) store_rows<kOT, float, kOW>(out, ib, ih, p.h, xrows, f0 + 16 * m + g, d, mine, acc[m]);
}

template <bool kResident>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_dq_wide_kernel(const Params p, const __grid_constant__ CUtensorMap tx0,
                         const __grid_constant__ CUtensorMap tx1, const __grid_constant__ CUtensorMap ty0,
                         const __grid_constant__ CUtensorMap ty1, const __grid_constant__ CUtensorMap tl,
                         const __grid_constant__ CUtensorMap td) {
  wide_body<false, kResident>(p, &tx0, &tx1, &ty0, &ty1, &tl, &td);
}

template <bool kResident>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_dkv_wide_kernel(const Params p, const __grid_constant__ CUtensorMap tx0,
                          const __grid_constant__ CUtensorMap tx1, const __grid_constant__ CUtensorMap ty0,
                          const __grid_constant__ CUtensorMap ty1, const __grid_constant__ CUtensorMap tl,
                          const __grid_constant__ CUtensorMap td) {
  wide_body<true, kResident>(p, &tx0, &tx1, &ty0, &ty1, &tl, &td);
}

// -- bf16 past kStagedMaxD: flash_dq_wide_bf16_kernel, flash_dkv_wide_bf16_kernel --------
// Mixed precision past head_dim 256 (csrc/flash_bf16_kernel.cu's wgmma
// bodies take bf16 up to it) runs PR 13's design of the fp32 body above,
// with the same roles, tiles, score split and pass: 8 warps and no
// producer, the loop operand's 128-column pieces read by all threads,
// widened to fp32 and stored row-major at a padded stride (kWld) into a
// ring of 2 slots one item ahead, one block barrier an item and one for
// the score partials; the fixed tile resident up to kWideResidentD,
// streamed in the ring past it. Every product takes one TF32 pass (exact
// on bf16 values), P and dS are rounded to bf16 before the products that
// read them (the reference's casts, flash_kernel.py:260, :297, :306), and
// dQ, dK and dV are rounded to bf16 as they are stored; LSE and delta stay
// fp32. The fp32 body's TMA ring would carry bf16 boxes of 64 columns
// that the consumers widen as they read them: not built yet (ROADMAP).

constexpr int kBThreads = 32 * kWideWarps;
constexpr int kWP = 8 * kPieceTiles;        // columns of a streamed piece
constexpr int kWld = ld_of<kPieceTiles>();  // row stride of a staged piece

// Floats of a ring slot: pieces of Y0 and Y1, and of X0 and X1 when the
// fixed tile is streamed.
__host__ __device__ constexpr int bf16_slot(bool resident) { return (resident ? 2 : 4) * kWideRows * kWld; }

// Shared floats of the bf16 body: the ring (2 slots), the score partials,
// the A fragments (dS and P; big and small, 8 fragments each) and the
// resident fixed tile (X0, X1 [kWideRows][d + 4]).
__host__ __device__ constexpr int bf16_floats(bool dkv, int d, bool resident) {
  return 2 * bf16_slot(resident) + 32 * kFrag + (dkv ? 4 : 2) * 8 * kFrag +
         (resident ? 2 * kWideRows * (d + 4) : 0);
}

static_assert(bf16_floats(true, kWideResidentD, true) * 4 <= kSmemMax &&
                  bf16_floats(true, kWideResidentD + 8, true) * 4 > kSmemMax,
              "kWideResidentD is the widest fixed tile that bf16 dK/dV holds resident");

// s[j] += X Y_j^T in one TF32 pass over `cnt` k-steps (all kPieceTiles / 2
// when kFull) of a piece, into a fresh accumulator: X the warp's 16 rows
// at stride ld, Y 32 rows at the piece stride, both at the first column of
// the warp's k-steps.
template <bool kFull>
__device__ __forceinline__ void score_piece_bf16(const float* X, int ld, const float* Y, float s[4][4], int cnt) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  X += g * ld + t;
  Y += g * kWld + t;
  float f[4][4];
  zero<4>(f);
#pragma unroll
  for (int k = 0; k < kPieceTiles / 2; ++k) {
    if (kFull || k < cnt) {
      const int c = 8 * k;
      const float a[4] = {X[c], X[8 * ld + c], X[c + 4], X[8 * ld + c + 4]};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(a[i], ab[i], as[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b[2] = {Y[8 * j * kWld + c], Y[8 * j * kWld + c + 4]};
        mma3<true>(f[j], ab, as, b);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += f[j][e];
}

// Columns [0, w) (w a multiple of 8, at most kWP) of rows [row0, row0 +
// kWideRows) of one head of a bf16 [b, s, h, d] tensor (base at the batch,
// head and first column), widened to fp32, into a ring piece
// [kWideRows][kWld]; rows at or past `rows` are zero. Each thread reads one
// 16-byte column piece of every kStep-th row, so a copy costs no index
// arithmetic.
__device__ __forceinline__ void stage_piece(float* dst, const __nv_bfloat16* base, int64_t stride, int row0,
                                            int rows, int w) {
  constexpr int kPerRow = kWP / 8, kStep = kBThreads / kPerRow;
  const int c = threadIdx.x % kPerRow, r0 = threadIdx.x / kPerRow;
  if (8 * c >= w) return;
  base += 8 * c;
  dst += 8 * c;
#pragma unroll
  for (int i = 0; i < kWideRows / kStep; ++i) {
    const int r = r0 + kStep * i;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) raw = __ldg(reinterpret_cast<const uint4*>(base + (int64_t)(row0 + r) * stride));
    widen_bf16x8(dst + r * kWld, raw);
  }
}

// The bf16 body of dQ (kDkv false) or dK/dV. Grid as the fp32 body's.
// Every barrier is reached by all threads.
template <bool kDkv>
__device__ __forceinline__ void wide_bf16_body(const Params& p) {
  using T = __nv_bfloat16;
  constexpr int kR = kWideRows, kOps = kDkv ? 2 : 1;
  extern __shared__ float4 smem4[];
  const int d = p.d, dt = d / 8, xld = d + 4;
  const bool resident = d <= kWideResidentD;
  const int slot = bf16_slot(resident);
  float* ring = reinterpret_cast<float*>(smem4);  // [2][slot]
  float* part = ring + 2 * slot;                   // [S, dP][k-half][m-tile][n-tile] fragments
  float* frag = part + 32 * kFrag;                 // [dS, P][big, small][m-tile][k-step] fragments
  float* xs = frag + kOps * 16 * kFrag;            // resident X0, X1 [kR][xld]
  int c0t, cn;  // this block's output columns: n-tiles [c0t, c0t + cn)
  z_chunk(dt, c0t, cn);
  const int c0 = 8 * c0t;
  const int f0 = blockIdx.x * kR, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* qb = reinterpret_cast<const T*>(p.q) + ib * p.q_sb + ih * p.q_sh;
  const T* gb = reinterpret_cast<const T*>(p.dout) + ib * p.g_sb + ih * p.g_sh;
  const T* kb = reinterpret_cast<const T*>(p.k) + ib * p.k_sb + ih * p.k_sh;
  const T* vb = reinterpret_cast<const T*>(p.v) + ib * p.v_sb + ih * p.v_sh;
  const T* x0b = kDkv ? kb : qb;
  const T* x1b = kDkv ? vb : gb;
  const T* y0b = kDkv ? qb : kb;
  const T* y1b = kDkv ? gb : vb;
  const int64_t x0s = kDkv ? p.k_ss : p.q_ss, x1s = kDkv ? p.v_ss : p.g_ss;
  const int64_t y0s = kDkv ? p.q_ss : p.k_ss, y1s = kDkv ? p.g_ss : p.v_ss;
  const int xrows = kDkv ? p.sk : p.sq, yrows = kDkv ? p.sq : p.sk;
  // loop tiles [l_start, l_start + n kR): dQ's stop at the causal
  // diagonal, dK/dV's start there
  int l_start = 0, n;
  if constexpr (kDkv) {
    l_start = p.causal ? f0 : 0;
    n = p.sq > l_start ? (p.sq - l_start + kR - 1) / kR : 0;
  } else {
    n = ((p.causal ? min(p.sk, f0 + kR) : p.sk) + kR - 1) / kR;
  }
  const int kp = (dt + kPieceTiles - 1) / kPieceTiles;  // score pieces a loop tile
  const int op = (cn + kPieceTiles - 1) / kPieceTiles;  // output pieces a loop tile
  const int per = kp + op, items = n * per;

  // item j into ring slot j % 2 (published by the barrier before its use)
  auto stage = [&](int item) {
    if (item < items) {
      const int it = item / per, r = item - it * per, row0 = l_start + it * kR;
      float* dst = ring + (item & 1) * slot;
      if (r < kp) {
        const int col = r * kWP, w = min(kWP, d - col);
        stage_piece(dst, y0b + col, y0s, row0, yrows, w);
        stage_piece(dst + kR * kWld, y1b + col, y1s, row0, yrows, w);
        if (!resident) {
          stage_piece(dst + 2 * kR * kWld, x0b + col, x0s, f0, xrows, w);
          stage_piece(dst + 3 * kR * kWld, x1b + col, x1s, f0, xrows, w);
        }
      } else {
        const int col = c0 + (r - kp) * kWP, w = min(kWP, c0 + 8 * cn - col);
        stage_piece(dst, y0b + col, y0s, row0, yrows, w);
        if (kDkv) stage_piece(dst + kR * kWld, y1b + col, y1s, row0, yrows, w);
      }
    }
  };
  if (resident) {
    load_tile_bf16<kR, kBThreads>(xs, xld, x0b, x0s, f0, xrows, d);
    load_tile_bf16<kR, kBThreads>(xs + kR * xld, xld, x1b, x1s, f0, xrows, d);
  }
  stage(0);

  // score role: product (0 S, 1 dP), m-tile and k-half of each piece
  const int prod = warp >> 2, smt = (warp >> 1) & 1, kh = warp & 1;
  // pass role: the scores' fragment (m-tile pmt, n-tile pj)
  const int pmt = warp >> 2, pj = warp & 3;
  float lse[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // dQ: of the pass rows, read once
  if constexpr (!kDkv) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = f0 + 16 * pmt + g + 8 * i;
      const int64_t off = ((int64_t)ib * p.h + ih) * p.sq + r;
      lse[i] = r < p.sq ? p.lse[off] : 0.f;
      dl[i] = r < p.sq ? p.delta[off] : 0.f;
    }
  }

  float acc0[2][kWideOT][4];             // dQ, or dK
  float acc1[2][kDkv ? kWideOT : 1][4];  // dV
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    zero<kWideOT>(acc0[m]);
    if constexpr (kDkv) zero<kWideOT>(acc1[m]);
  }
  int j = 0;  // the item in hand
  for (int it = 0; it < n; ++it) {
    const int l0 = l_start + it * kR;
    float lt[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};  // dK/dV: of the pass columns' queries
    if constexpr (kDkv) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = l0 + 8 * pj + 2 * t + e;
        const int64_t off = ((int64_t)ib * p.h + ih) * p.sq + qi;
        lt[e] = qi < p.sq ? p.lse[off] : 0.f;
        dlt[e] = qi < p.sq ? p.delta[off] : 0.f;
      }
    }
    float s[4][4];
    zero<4>(s);
    for (int pc = 0; pc < kp; ++pc, ++j) {
      __syncthreads();  // item j is in; every warp is done with item j - 1, whose slot j + 1 takes
      stage(j + 1);
      const float* sl = ring + (j & 1) * slot;
      const int ld = resident ? xld : kWld;
      const float* X = (resident ? xs + prod * kR * xld + pc * kWP : sl + (2 + prod) * kR * kWld) + 16 * smt * ld;
      const float* Y = sl + prod * kR * kWld;
      const int ks = min(kPieceTiles, dt - pc * kPieceTiles), half = (ks + 1) / 2;
      const int k0 = kh ? half : 0, k1 = kh ? ks : half;
      if (ks == kPieceTiles)
        score_piece_bf16<true>(X + 8 * k0, ld, Y + 8 * k0, s, k1 - k0);
      else
        score_piece_bf16<false>(X + 8 * k0, ld, Y + 8 * k0, s, k1 - k0);
    }
    {
      float4* pw = reinterpret_cast<float4*>(part) + ((prod * 2 + kh) * 2 + smt) * 4 * 32 + lane;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) pw[32 * jj] = make_float4(s[jj][0], s[jj][1], s[jj][2], s[jj][3]);
    }
    __syncthreads();  // the partials are in
    {
      // this thread's 4 scores: S and dP summed over the k-halves
      constexpr int kRole = 2 * 4 * 32;  // float4s of one (product, k-half)
      const float4* pr = reinterpret_cast<const float4*>(part) + (pmt * 4 + pj) * 32 + lane;
      const float4 s0 = pr[0], s1 = pr[kRole], d0 = pr[2 * kRole], d1 = pr[3 * kRole];
      const float sv[4] = {s0.x + s1.x, s0.y + s1.y, s0.z + s1.z, s0.w + s1.w};
      const float dv[4] = {d0.x + d1.x, d0.y + d1.y, d0.z + d1.z, d0.w + d1.w};
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int fr = f0 + 16 * pmt + g + 8 * (e >> 1), lr = l0 + 8 * pj + 2 * t + (e & 1);
        const bool ok = kDkv ? visible(p, lr, fr) : visible(p, fr, lr);
        const float ls = kDkv ? lt[e & 1] : lse[e >> 1], de = kDkv ? dlt[e & 1] : dl[e >> 1];
        const float pe = ok ? expf(sv[e] * p.scale - ls) : 0.f;
        pv[e] = operand<T>(pe);
        dsv[e] = operand<T>(pe * (dv[e] - de) * p.scale);
      }
      float* fa = frag + (pmt * 4 + pj) * kFrag + 4 * lane;
      put_a<true>(fa, fa + 8 * kFrag, dsv);
      if constexpr (kDkv) put_a<true>(fa + 16 * kFrag, fa + 24 * kFrag, pv);
    }
#pragma unroll
    for (int pc = 0; pc < kWideOT / 2; ++pc) {
      if (pc < op) {
        __syncthreads();  // item j (and at pc 0 the A fragments) is in; every warp is done with item j - 1
        stage(j + 1);
        const float* sl = ring + (j & 1) * slot;
#pragma unroll
        for (int kk = 0; kk < kR / 8; ++kk) {
          uint32_t ab[kOps][2][4], as[kOps][2][4];
#pragma unroll
          for (int o = 0; o < kOps; ++o)
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const float* fa = frag + (o * 16 + m * 4 + kk) * kFrag + 4 * lane;
              get_a<true>(fa, fa + 8 * kFrag, ab[o][m], as[o][m]);
            }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (16 * pc + 8 * i + warp < cn) {
              // B: rows 8 kk + 2t (+1) of the piece, columns of the warp's n-tile
              const float* yb = sl + (8 * kk + 2 * t) * kWld + 8 * (8 * i + warp) + g;
              uint32_t bb[2], bs[2];
              split(yb[0], bb[0], bs[0]);
              split(yb[kWld], bb[1], bs[1]);
#pragma unroll
              for (int m = 0; m < 2; ++m) mma3_split<true>(acc0[m][2 * pc + i], ab[0][m], as[0][m], bb, bs);
              if constexpr (kDkv) {
                split(yb[kR * kWld], bb[0], bs[0]);
                split(yb[kR * kWld + kWld], bb[1], bs[1]);
#pragma unroll
                for (int m = 0; m < 2; ++m) mma3_split<true>(acc1[m][2 * pc + i], ab[1][m], as[1][m], bb, bs);
              }
            }
          }
        }
        ++j;
      }
    }
  }
  const int mine = (cn - warp + 7) / 8;  // this warp's n-tiles 8u + warp below cn
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int r0 = f0 + 16 * m + g;
    store_rows<kWideOT, T, 8>(reinterpret_cast<T*>(p.out0) + c0 + 8 * warp, ib, ih, p.h, xrows, r0, d, mine, acc0[m]);
    if constexpr (kDkv)
      store_rows<kWideOT, T, 8>(reinterpret_cast<T*>(p.out1) + c0 + 8 * warp, ib, ih, p.h, xrows, r0, d, mine,
                                acc1[m]);
  }
}

__global__ void __launch_bounds__(kBThreads, 1) flash_dq_wide_bf16_kernel(const Params p) {
  wide_bf16_body<false>(p);
}

__global__ void __launch_bounds__(kBThreads, 1) flash_dkv_wide_bf16_kernel(const Params p) {
  wide_bf16_body<true>(p);
}

// -- fp32 up to kMmaMaxD: flash_dq_tf32_kernel, flash_dkv_tf32_kernel ------------------
// One body (tf32_body) runs both, naming its operands by role as the wide
// body does: the fixed tile X (dQ: Q and dO; dK/dV: K and V) is kM rows of
// one block, the loop tiles Y (dQ: K and V; dK/dV: Q and dO) are kN rows.
// Per loop tile:
//   scores  S = X0 Y0^T and dP = X1 Y1^T, .tf32 wgmma by the consumer
//           warpgroup of each 64 fixed rows, both operands K-major from
//           shared memory;
//   P, dS   in registers, in the wgmma accumulator (the mma.sync m16n8
//           layout, so the masks and the exponentials are the mma
//           body's);
//   outputs dQ += dS Y0, or dK += dS^T Y0 and dV += P^T Y1, .tf32 wgmma
//           with dS and P as the A operand from registers (the k index
//           permuted as product_pn's) and B the loop operand's transposed
//           copies.
// The header's note says why and what was measured.

// The block of bucket kB (32-column boxes of head_dim: 1, 2 or 4): kWG
// consumer warpgroups of 64 fixed rows and a ring of kS slots of 32-row
// loop tiles.
template <int kB_, int kWG_, int kS_>
struct Tf32Cfg {
  static constexpr int kB = kB_, kWG = kWG_, kS = kS_;
  static constexpr int kN = 32;                          // loop rows: a transposed row is 128 bytes
  static constexpr int kPW = 2;                          // producer warpgroups
  static constexpr int kM = 64 * kWG;                    // fixed rows of a block
  static constexpr int kThreads = 128 * (kWG + kPW);     // the consumers, then the producer warpgroups
  static constexpr int kXBox = kM * 32, kYBox = kN * 32;  // floats of a 32-column box of X, of Y
  static constexpr int kFixed = 4 * kB * kXBox;          // X0, X1, then their small copies
  // Y0, Y1, their small copies, then the transposed tiles (dQ: K^T big and
  // small; dK/dV: Q^T and dO^T): head_dim rows of the tile's 32 rows, 128
  // bytes a row, in the boxes' swizzle
  __host__ __device__ static constexpr int slot(bool dkv) { return (dkv ? 8 : 6) * kB * kYBox; }
  // dK/dV: a loop tile's LSE and delta in one flat box each, from the
  // 16-byte boundary at or before its first query (kRowBox values), in
  // row slots of a multiple of 128 bytes
  static constexpr int kRowBox = kN + 4, kRowSlot = 32 * ((kN + 4 + 31) / 32);
  // the producers' warps but the first (whose lane 0 issues the loads)
  // write the small copies and transposes
  static constexpr int kSplitters = 128 * kPW - 32;
  // registers: the launch bound's share of the SM, then moved from the
  // producers to the consumers by setmaxnreg
  static constexpr int kProducerRegs = 40;
  static constexpr int kLaunchRegs = (65536 / kThreads) / 8 * 8;
  static constexpr int kFreed = (kLaunchRegs - kProducerRegs) * kPW / kWG / 8 * 8;
  static constexpr int kConsumerRegs = kLaunchRegs + kFreed < 240 ? kLaunchRegs + kFreed : 240;
  static constexpr int kBars = 2 + 3 * kS;  // full and ready of X; full, ready and empty of each slot
  static constexpr size_t bytes(bool dkv) {
    return 1024 + 4 * (kFixed + kS * slot(dkv) + (dkv ? 2 * kS * kRowSlot : 0)) + 8 * kBars;
  }
};

// The block of each kernel and bucket (scripts/flash_bwd_tf32_variants.py
// times the alternatives): head_dim <= 32, <= 64, and dQ's <= 128 (dK/dV
// runs flash_dkv_mma_kernel there).
using DqB0 = Tf32Cfg<1, 2, 4>;
using DkvB0 = Tf32Cfg<1, 2, 4>;
using DqB1 = Tf32Cfg<2, 2, 2>;
using DkvB1 = Tf32Cfg<2, 1, 2>;
using DqB2 = Tf32Cfg<4, 1, 1>;

static_assert(DqB0::bytes(false) <= kSmemMax && DkvB0::bytes(true) <= kSmemMax && DqB1::bytes(false) <= kSmemMax &&
                  DkvB1::bytes(true) <= kSmemMax && DqB2::bytes(false) <= kSmemMax,
              "a block's tiles fit the shared memory a block may take");

// x - big, where big is x with its 13 low mantissa bits cleared (what the
// tensor cores read of x), plus half a TF32 ulp, which they read as
// tf32_rna(x - big): split()'s small part, as a float to store.
__device__ __forceinline__ float small_of(float x) {
  return __uint_as_float(__float_as_uint(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u)) + 0x1000u);
}

// dst[i] = small_of(src[i]) for the n4 float4s of src, thread `i0` of
// `step` (neighbouring threads on neighbouring 16 bytes). The swizzle
// moves whole 16-byte chunks, so a copy in the same layout is elementwise.
__device__ __forceinline__ void write_small(float* dst, const float* src, int n4, int i0, int step) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = i0; i < n4; i += step) {
    const float4 v = s4[i];
    d4[i] = make_float4(small_of(v.x), small_of(v.y), small_of(v.z), small_of(v.w));
  }
}

// The split of one loop operand whose output product runs on wgmma: its
// small copy as write_small's, and its transpose, big (the raw values)
// and small, into tb and ts: row c (a head_dim column, 8-row groups of
// 1024 bytes) holds the tile's 32 rows (the contraction) in the boxes'
// 128-byte swizzle, each group of 8 rows in the order the A fragment's k
// slots take them (slot t: row 2t, slot t + 4: row 2t + 1; product_pn's
// permutation). Warp w of nw: lane = the tile's row, 4 columns a step;
// the reads and the writes are free of bank conflicts.
template <int kB, int kYBox>
__device__ __forceinline__ void write_split_t(float* small, float* tb, float* ts, const float* raw, int w, int nw,
                                              int lane) {
  const int pos = (lane & ~7) + ((lane & 7) >> 1) + 4 * (lane & 1);
  for (int q = w; q < 8 * kB; q += nw) {
    const int c0 = 4 * q, off = (c0 >> 5) * kYBox + swz(lane, c0 & 31);
    const float4 v = *reinterpret_cast<const float4*>(raw + off);
    const float x[4] = {v.x, v.y, v.z, v.w};
    const float y[4] = {small_of(v.x), small_of(v.y), small_of(v.z), small_of(v.w)};
    *reinterpret_cast<float4*>(small + off) = make_float4(y[0], y[1], y[2], y[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + e, to = c * 32 + (((pos >> 2) ^ (c & 7)) << 2) + (pos & 3);
      tb[to] = x[e];
      ts[to] = y[e];
    }
  }
}

// acc (+)= A Yt over a loop tile's 4 k8 steps in 3xTF32 (small·big,
// big·small, big·big at each step into the one chain): A the
// warpgroup's 64 x 32 dS or P from registers, the fragments fb (raw bits)
// and fs (small parts) of each k8 step; Yt a transposed tile of kND
// head_dim rows (big tb, small ts). Issued inside the caller's fences.
template <int kND>
__device__ __forceinline__ void issue_tf32_out(float (&acc)[kND / 2], const uint32_t (&fb)[4][4],
                                               const uint32_t (&fs)[4][4], const float* tb, const float* ts) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hopper::WgmmaTf32RS<kND>::run(acc, fs[kk], hopper::desc_kmajor_tf32(tb, kk), 1);
    hopper::WgmmaTf32RS<kND>::run(acc, fb[kk], hopper::desc_kmajor_tf32(ts, kk), 1);
    hopper::WgmmaTf32RS<kND>::run(acc, fb[kk], hopper::desc_kmajor_tf32(tb, kk), 1);
  }
}

// The A fragments of each k8 step kk of a warp's 16 x 32 accumulator f:
// the values of columns 8 kk + 2t, + 1 in k slots t, t + 4 (rows g, g + 8).
__device__ __forceinline__ void a_fragments(const float (&f)[16], uint32_t (&fb)[4][4], uint32_t (&fs)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float a[4] = {f[4 * kk], f[4 * kk + 2], f[4 * kk + 1], f[4 * kk + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fb[kk][i] = __float_as_uint(a[i]);
      fs[kk][i] = __float_as_uint(small_of(a[i]));
    }
  }
}

// big (+)= Xb Yb^T and small (+)= Xs Yb^T + Xb Ys^T over the bucket's kB
// boxes (4 k8 steps each), in that order at each k8 step (mma3_split's);
// X the warpgroup's 64 rows in boxes of kXRows rows, Y kN rows, raw (b)
// and small copies (s) kFar floats past the raw ones. fresh: the chains
// start over. Issued inside the caller's fences.
template <int kB, int kN, int kXRows>
__device__ __forceinline__ void issue_tf32_scores(float (&big)[kN / 2], float (&small)[kN / 2], const float* x,
                                                  int x_far, const float* y, int y_far) {
#pragma unroll
  for (int bx = 0; bx < kB; ++bx)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* xb = x + bx * kXRows * 32;
      const float* yb = y + bx * kN * 32;
      const int keep = bx + kk > 0;
      hopper::WgmmaTf32SS<kN>::run(small, hopper::desc_kmajor_tf32(xb + x_far, kk), hopper::desc_kmajor_tf32(yb, kk),
                                   keep);
      hopper::WgmmaTf32SS<kN>::run(small, hopper::desc_kmajor_tf32(xb, kk), hopper::desc_kmajor_tf32(yb + y_far, kk),
                                   1);
      hopper::WgmmaTf32SS<kN>::run(big, hopper::desc_kmajor_tf32(xb, kk), hopper::desc_kmajor_tf32(yb, kk), keep);
    }
}

// dQ's pass: dS of the warp's 16 x kN scores in place of dP, p = exp(s
// scale - lse), ds = p (dp - delta) scale, 0 where masked (kMasked), rows
// r0, r0 + 8 and keys k0 + 8j + 2t (+1).
template <bool kMasked, int kN>
__device__ __forceinline__ void tf32_ds_rows(const Params& p, int r0, int k0, const float lse[2], const float dl[2],
                                             const float (&s)[kN / 2], float (&dp)[kN / 2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const bool ok = !kMasked || visible(p, r0 + 8 * i, k0 + 8 * j + 2 * t + (e & 1));
      const float pr = ok ? expf(s[4 * j + e] * p.scale - lse[i]) : 0.f;
      dp[4 * j + e] = pr * (dp[4 * j + e] - dl[i]) * p.scale;
    }
}

// dK/dV's pass: P^T and dS^T of the warp's 16 keys (r0, r0 + 8) x the
// tile's kN queries (q0 + 8j + 2t (+1)), whose LSE and delta are lt, dlt,
// in place of S^T and dP^T.
template <bool kMasked, int kN>
__device__ __forceinline__ void tf32_ds_cols(const Params& p, int r0, int q0, const float* lt, const float* dlt,
                                             float (&s)[kN / 2], float (&dp)[kN / 2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1);
      const bool ok = !kMasked || visible(p, q0 + col, r0 + 8 * (e >> 1));
      const float pr = ok ? expf(s[4 * j + e] * p.scale - lt[col]) : 0.f;
      s[4 * j + e] = pr;
      dp[4 * j + e] = pr * (dp[4 * j + e] - dlt[col]) * p.scale;
    }
}

// The body of dQ (kDkv false) or dK/dV. Grid: (fixed tiles of kM rows,
// b h). Tensor maps of the fixed (tx0, tx1; boxes of 32 columns x kM rows)
// and loop (ty0, ty1; 32 x kN) operands, and flat ones of LSE and delta
// (tl, td; read by dK/dV), boxes of kRowBox values.
template <bool kDkv, class C>
__device__ __forceinline__ void tf32_body(const Params& p, const CUtensorMap* tx0, const CUtensorMap* tx1,
                                          const CUtensorMap* ty0, const CUtensorMap* ty1, const CUtensorMap* tl,
                                          const CUtensorMap* td) {
  constexpr int kB = C::kB, kN = C::kN, kS = C::kS, kM = C::kM, kDT = 4 * kB, kSlot = C::slot(kDkv);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* fixed = reinterpret_cast<float*>(smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));
  float* ring = fixed + C::kFixed;                      // [slot][Y0, Y1, their small copies, transposes]
  float* rows = ring + kS * kSlot;                      // dK/dV: [slot][LSE, delta][kRowSlot]
  uint64_t* full_x = reinterpret_cast<uint64_t*>(rows + (kDkv ? 2 * kS * C::kRowSlot : 0));
  uint64_t* ready_x = full_x + 1;
  uint64_t* full = ready_x + 1;  // a slot's TMA bytes are in
  uint64_t* ready = full + kS;   // ... and its small copies
  uint64_t* empty = ready + kS;  // every consumer warp is done with it
  const int d = p.d, dt = d / 8;
  const int f0 = blockIdx.x * kM, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int xrows = kDkv ? p.sk : p.sq;
  // loop tiles [l_start, l_start + n kN): dQ's stop at the causal
  // diagonal, dK/dV's start there (none where sq <= f0)
  int l_start = 0, n;
  if constexpr (kDkv) {
    l_start = p.causal ? f0 : 0;
    n = p.sq > l_start ? (p.sq - l_start + kN - 1) / kN : 0;
  } else {
    n = ((p.causal ? min(p.sk, f0 + kM) : p.sk) + kN - 1) / kN;
  }
  if (threadIdx.x == 0) {
    hopper::mbar_init(full_x, 1);
    hopper::mbar_init(ready_x, C::kSplitters);
    for (int i = 0; i < kS; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&ready[i], C::kSplitters);
      hopper::mbar_init(&empty[i], 4 * C::kWG);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi >= C::kWG) {  // the producer warpgroups
    hopper::regs_dec<C::kProducerRegs>();
    if (n == 0) return;  // dK/dV of keys no query sees: zeros, nothing loaded
    if (threadIdx.x < 128 * C::kWG + 32) {  // one thread issues every load
      if ((threadIdx.x & 31) != 0) return;
      hopper::prefetch_map(tx0);
      hopper::prefetch_map(tx1);
      hopper::prefetch_map(ty0);
      hopper::prefetch_map(ty1);
      if (kDkv) {
        hopper::prefetch_map(tl);
        hopper::prefetch_map(td);
      }
      // boxes past the tensor's rows or columns arrive zero-filled
      hopper::mbar_expect_tx(full_x, 2 * kB * C::kXBox * 4);
      for (int bx = 0; bx < kB; ++bx) {
        hopper::tma_load_4d(fixed + bx * C::kXBox, tx0, full_x, 32 * bx, f0, ih, ib);
        hopper::tma_load_4d(fixed + (kB + bx) * C::kXBox, tx1, full_x, 32 * bx, f0, ih, ib);
      }
      for (int it = 0; it < n; ++it) {
        const int slot = it % kS, l0 = l_start + it * kN;
        float* dst = ring + slot * kSlot;
        hopper::mbar_wait(&empty[slot], ((it / kS) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[slot], 2 * kB * C::kYBox * 4 + (kDkv ? 2 * C::kRowBox * 4 : 0));
        for (int bx = 0; bx < kB; ++bx) {
          hopper::tma_load_4d(dst + bx * C::kYBox, ty0, &full[slot], 32 * bx, l0, ih, ib);
          hopper::tma_load_4d(dst + (kB + bx) * C::kYBox, ty1, &full[slot], 32 * bx, l0, ih, ib);
        }
        if constexpr (kDkv) {
          const int r0 = (int)((((int64_t)ib * p.h + ih) * p.sq + l0) & ~3ll);
          hopper::tma_load_1d(rows + slot * 2 * C::kRowSlot, tl, &full[slot], r0);
          hopper::tma_load_1d(rows + slot * 2 * C::kRowSlot + C::kRowSlot, td, &full[slot], r0);
        }
      }
      return;
    }
    // the other warps: the small copies (and transposes), once per staged tile
    const int i0 = threadIdx.x - 128 * C::kWG - 32;
    hopper::mbar_wait(full_x, 0);
    write_small(fixed + 2 * kB * C::kXBox, fixed, 2 * kB * C::kXBox / 4, i0, C::kSplitters);
    hopper::fence_proxy_async();
    hopper::mbar_arrive(ready_x);
    constexpr int kOp = kB * C::kYBox, nw = C::kSplitters / 32;  // floats of one operand's tile; warps
    const int w = i0 >> 5, lane = i0 & 31;
    for (int it = 0; it < n; ++it) {
      const int slot = it % kS;
      float* sl = ring + slot * kSlot;
      hopper::mbar_wait(&full[slot], (it / kS) & 1);
      // Y0 (and for dK/dV Y1) also transposed for its output product
      write_split_t<kB, C::kYBox>(sl + 2 * kOp, sl + 4 * kOp, sl + 5 * kOp, sl, w, nw, lane);
      if constexpr (kDkv)
        write_split_t<kB, C::kYBox>(sl + 3 * kOp, sl + 6 * kOp, sl + 7 * kOp, sl + kOp, w, nw, lane);
      else
        write_small(sl + 3 * kOp, sl + kOp, kOp / 4, i0, C::kSplitters);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&ready[slot]);
    }
    return;
  }
  hopper::regs_inc<C::kConsumerRegs>();

  // a consumer warpgroup: fixed rows f0 + 64 wgi .. + 63, warp w of them 16
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2;
  const int wf = f0 + 64 * wgi, w0 = wf + 16 * warp, r0 = w0 + g;  // this lane's fixed rows r0, r0 + 8
  float acc0[kB * 16], acc1[kB * 16];  // dQ (acc1 unused), or dK and dV: wgmma m64n(32 kB) accumulators
#pragma unroll
  for (int i = 0; i < kB * 16; ++i) acc0[i] = acc1[i] = 0.f;
  float lse[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // dQ: of the lane's rows, read once
  if constexpr (!kDkv) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const int64_t off = ((int64_t)ib * p.h + ih) * p.sq + r;
      lse[i] = r < p.sq ? p.lse[off] : 0.f;
      dl[i] = r < p.sq ? p.delta[off] : 0.f;
    }
  }
  if (n > 0) {
    hopper::mbar_wait(full_x, 0);
    hopper::mbar_wait(ready_x, 0);
  }
  const float* x0 = fixed + 64 * wgi * 32;  // X0 at the warpgroup's first row; X1 kB boxes on
  constexpr int kXFar = 2 * kB * C::kXBox, kOp = kB * C::kYBox;  // X raw to small; one loop operand
  for (int it = 0; it < n; ++it) {
    const int slot = it % kS, l0 = l_start + it * kN;
    const uint32_t ph = (it / kS) & 1;
    hopper::mbar_wait(&full[slot], ph);
    hopper::mbar_wait(&ready[slot], ph);
    const float* sl = ring + slot * kSlot;
    // causal: loop tiles wholly past this warpgroup's diagonal add nothing
    if (!p.causal || (kDkv ? l0 + kN > wf : l0 <= wf + 63)) {
      float sb[kN / 2], ss[kN / 2], pb[kN / 2], ps[kN / 2];  // S and dP: big and small chains
      hopper::fence_regs(sb);
      hopper::fence_regs(ss);
      hopper::fence_regs(pb);
      hopper::fence_regs(ps);
      hopper::wgmma_fence();
      issue_tf32_scores<kB, kN, kM>(sb, ss, x0, kXFar, sl, 2 * kOp);                           // S
      issue_tf32_scores<kB, kN, kM>(pb, ps, x0 + kB * C::kXBox, kXFar, sl + kOp, 2 * kOp);  // dP
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sb);
      hopper::fence_regs(ss);
      hopper::fence_regs(pb);
      hopper::fence_regs(ps);
      float s[kN / 2], dp[kN / 2];
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        s[i] = sb[i] + ss[i];
        dp[i] = pb[i] + ps[i];
      }
      if constexpr (kDkv) {
        const float* lt = rows + slot * 2 * C::kRowSlot + (int)((((int64_t)ib * p.h + ih) * p.sq + l0) & 3);
        const bool all = l0 + kN <= p.sq && w0 + 16 <= p.sk && (!p.causal || l0 >= w0 + 15);
        if (all)
          tf32_ds_cols<false, kN>(p, r0, l0, lt, lt + C::kRowSlot, s, dp);
        else
          tf32_ds_cols<true, kN>(p, r0, l0, lt, lt + C::kRowSlot, s, dp);
      } else {
        const bool all = w0 + 16 <= p.sq && l0 + kN <= p.sk && (!p.causal || w0 >= l0 + kN - 1);
        if (all)
          tf32_ds_rows<false, kN>(p, r0, l0, lse, dl, s, dp);
        else
          tf32_ds_rows<true, kN>(p, r0, l0, lse, dl, s, dp);
      }
      // dQ += dS K, or dK += dS^T Q and dV += P^T dO, over the transposes
      uint32_t db[4][4], ds[4][4], pfb[4][4], pfs[4][4];
      a_fragments(dp, db, ds);
      if constexpr (kDkv) a_fragments(s, pfb, pfs);
      hopper::fence_regs(acc0);
      hopper::fence_regs(db);
      hopper::fence_regs(ds);
      if constexpr (kDkv) {
        hopper::fence_regs(acc1);
        hopper::fence_regs(pfb);
        hopper::fence_regs(pfs);
      }
      hopper::wgmma_fence();
      issue_tf32_out<kB * 32>(acc0, db, ds, sl + 4 * kOp, sl + 5 * kOp);
      if constexpr (kDkv) issue_tf32_out<kB * 32>(acc1, pfb, pfs, sl + 6 * kOp, sl + 7 * kOp);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc0);
      hopper::fence_regs(db);
      hopper::fence_regs(ds);
      if constexpr (kDkv) {
        hopper::fence_regs(acc1);
        hopper::fence_regs(pfb);
        hopper::fence_regs(pfs);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[slot]);
  }
  using Frag = float(*)[4];  // the accumulator as the m16n8 fragments store_rows takes
  store_rows<kDT>(p.out0, ib, ih, p.h, xrows, r0, d, dt, reinterpret_cast<Frag>(acc0));
  if constexpr (kDkv) store_rows<kDT>(p.out1, ib, ih, p.h, xrows, r0, d, dt, reinterpret_cast<Frag>(acc1));
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_dq_tf32_kernel(const Params p, const __grid_constant__ CUtensorMap tx0,
                         const __grid_constant__ CUtensorMap tx1, const __grid_constant__ CUtensorMap ty0,
                         const __grid_constant__ CUtensorMap ty1, const __grid_constant__ CUtensorMap tl,
                         const __grid_constant__ CUtensorMap td) {
  tf32_body<false, C>(p, &tx0, &tx1, &ty0, &ty1, &tl, &td);
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_dkv_tf32_kernel(const Params p, const __grid_constant__ CUtensorMap tx0,
                          const __grid_constant__ CUtensorMap tx1, const __grid_constant__ CUtensorMap ty0,
                          const __grid_constant__ CUtensorMap ty1, const __grid_constant__ CUtensorMap tl,
                          const __grid_constant__ CUtensorMap td) {
  tf32_body<true, C>(p, &tx0, &tx1, &ty0, &ty1, &tl, &td);
}

// -- launch ----------------------------------------------------------------------------

enum Kind { kDq = 0, kDkv = 1 };

// head_dims up to this run the mma kernels (kDT = 4, 8 or 16, staged at
// full width); past it the wide kernels
constexpr int kMmaMaxD = 128;

bool wide(int d) { return d > kMmaMaxD; }

bool resident(int d) { return d <= kWideResidentD; }

int grid_z(int d) { return (d / 8 + kWideChunkTiles - 1) / kWideChunkTiles; }

// 0-2: the tf32 bodies' buckets; 3 the wide body with X resident, 4 with X streamed
int slot_of(int d) { return wide(d) ? (resident(d) ? 3 : 4) : bucket(d); }

// The tf32 bodies: Tf32Cfg::bytes; the wide kernels: wide_bytes.
// dK/dV at head_dim 72-128 (bucket 2) runs the 3xTF32 mma.sync body
// (flash_dkv_mma_kernel<16>): its tf32 body does not fit there with the
// output products on wgmma (the header says why)
bool mma_body(int kind, int d) { return kind == kDkv && !wide(d) && bucket(d) == 2; }

size_t smem_bytes(int kind, int d) {
  if (wide(d)) return wide_bytes(d, resident(d));
  const bool dkv = kind == kDkv;
  if (mma_body(kind, d)) return ((2 * kTile + 4 * kLoop) * ld_of<16>() + (dkv ? 4 * kLoop : 0)) * sizeof(float);
  const int b = bucket(d);
  if (dkv) return b == 0 ? DkvB0::bytes(true) : DkvB1::bytes(true);
  return b == 0 ? DqB0::bytes(false) : b == 1 ? DqB1::bytes(false) : DqB2::bytes(false);
}

size_t bf16_smem_bytes(int kind, int d) { return bf16_floats(kind == kDkv, d, resident(d)) * sizeof(float); }

void* kernel_of(int kind, int d) {
  static void* const table[2][5] = {
      {(void*)flash_dq_tf32_kernel<DqB0>, (void*)flash_dq_tf32_kernel<DqB1>, (void*)flash_dq_tf32_kernel<DqB2>,
       (void*)flash_dq_wide_kernel<true>, (void*)flash_dq_wide_kernel<false>},
      {(void*)flash_dkv_tf32_kernel<DkvB0>, (void*)flash_dkv_tf32_kernel<DkvB1>, (void*)flash_dkv_mma_kernel<16>,
       (void*)flash_dkv_wide_kernel<true>, (void*)flash_dkv_wide_kernel<false>}};
  return table[kind][slot_of(d)];
}

int threads_of(int kind, int d) {
  if (wide(d)) return kWideThreads;
  if (mma_body(kind, d)) return kThreads;
  const int b = bucket(d);
  if (kind == kDkv) return b == 0 ? DkvB0::kThreads : DkvB1::kThreads;
  return b == 0 ? DqB0::kThreads : b == 1 ? DqB1::kThreads : DqB2::kThreads;
}

void* wide_bf16_of(int kind) {
  return kind == kDq ? (void*)flash_dq_wide_bf16_kernel : (void*)flash_dkv_wide_bf16_kernel;
}

// fn's dynamic shared memory limit, and the carveout that gives it
int set_smem(void* fn, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

// Sets each kernel's shared-memory cap once: its size, for the fp32 wide
// body all a block may take (its ring takes what the rest leaves).
int configure(int kind, int d) {
  static bool configured[2][5] = {};
  const int si = slot_of(d);
  if (configured[kind][si]) return 0;
  const int e = set_smem(kernel_of(kind, d), wide(d) ? kSmemMax : (int)smem_bytes(kind, d));
  if (e) return e;
  configured[kind][si] = true;
  return 0;
}

// The bf16 body's cap: the most of any head_dim (the resident tile at
// kWideResidentD).
int configure_bf16(int kind) {
  static bool configured[2] = {};
  if (configured[kind]) return 0;
  const int e = set_smem(wide_bf16_of(kind), (int)bf16_smem_bytes(kind, kWideResidentD));
  if (e) return e;
  configured[kind] = true;
  return 0;
}

int launch_status(cudaError_t e) { return e != cudaSuccess ? (int)e : (int)cudaGetLastError(); }

template <bool kRes>
void launch_wide_as(int kind, dim3 grid, size_t bytes, cudaStream_t stream, const Params& p,
                    const CUtensorMap* x, const CUtensorMap* y, const CUtensorMap* r) {
  if (kind == kDq)
    flash_dq_wide_kernel<kRes><<<grid, kWideThreads, bytes, stream>>>(p, x[0], x[1], y[0], y[1], r[0], r[1]);
  else
    flash_dkv_wide_kernel<kRes><<<grid, kWideThreads, bytes, stream>>>(p, x[0], x[1], y[0], y[1], r[0], r[1]);
}

// The fp32 wide kernels: q, dO, k and v in boxes of 32 columns x
// kWideRows rows, LSE and delta read flat in boxes of kRowBox values
// (b h sq below 2^31), maps encoded per call; X = (q, dO) and Y = (k, v)
// for dQ, the other way round for dK/dV.
int launch_wide(int kind, const Params& p, int b, int rows, cudaStream_t stream) {
  CUtensorMap maps[6];
  const float* ptr[4] = {p.q, p.dout, p.k, p.v};
  const int64_t st[4][3] = {
      {p.q_sb, p.q_ss, p.q_sh}, {p.g_sb, p.g_ss, p.g_sh}, {p.k_sb, p.k_ss, p.k_sh}, {p.v_sb, p.v_ss, p.v_sh}};
  for (int i = 0; i < 4; ++i) {
    const int e = hopper::encode_bshd_f32(&maps[i], ptr[i], b, i < 2 ? p.sq : p.sk, p.h, p.d, st[i][0], st[i][1],
                                          st[i][2], kWideRows);
    if (e) return e;
  }
  const int64_t n = (int64_t)b * p.h * p.sq;
  int e = hopper::encode_flat_f32(&maps[4], p.lse, n, kRowBox);
  if (!e) e = hopper::encode_flat_f32(&maps[5], p.delta, n, kRowBox);
  if (e) return e;
  const CUtensorMap* x = kind == kDq ? maps : maps + 2;
  const CUtensorMap* y = kind == kDq ? maps + 2 : maps;
  const dim3 grid((rows + kWideRows - 1) / kWideRows, b * p.h, grid_z(p.d));
  const size_t bytes = smem_bytes(kind, p.d);
  if (resident(p.d))
    launch_wide_as<true>(kind, grid, bytes, stream, p, x, y, maps + 4);
  else
    launch_wide_as<false>(kind, grid, bytes, stream, p, x, y, maps + 4);
  return (int)cudaGetLastError();
}

// The tf32 bodies (head_dim up to kMmaMaxD) at block C: the fixed
// operand (dQ: q and dO; dK/dV: k and v) in boxes of 32 columns x C::kM
// rows, the loop operand in boxes of 32 x C::kN, maps encoded per call;
// dK/dV also reads LSE and delta flat in boxes of C::kRowBox values (b h
// sq below 2^31).
template <class C>
int launch_tf32(int kind, const Params& p, int b, int rows, cudaStream_t stream) {
  const bool dkv = kind == kDkv;
  CUtensorMap maps[6] = {};  // X0, X1, Y0, Y1, LSE, delta
  const float* ptr[4] = {p.q, p.dout, p.k, p.v};
  const int64_t st[4][3] = {
      {p.q_sb, p.q_ss, p.q_sh}, {p.g_sb, p.g_ss, p.g_sh}, {p.k_sb, p.k_ss, p.k_sh}, {p.v_sb, p.v_ss, p.v_sh}};
  for (int i = 0; i < 4; ++i) {
    const bool fixed = dkv ? i >= 2 : i < 2;
    const int e = hopper::encode_bshd_f32(&maps[(fixed ? 0 : 2) + i % 2], ptr[i], b, i < 2 ? p.sq : p.sk, p.h, p.d,
                                          st[i][0], st[i][1], st[i][2], fixed ? C::kM : C::kN);
    if (e) return e;
  }
  if (dkv) {
    const int64_t n = (int64_t)b * p.h * p.sq;
    int e = hopper::encode_flat_f32(&maps[4], p.lse, n, C::kRowBox);
    if (!e) e = hopper::encode_flat_f32(&maps[5], p.delta, n, C::kRowBox);
    if (e) return e;
  }
  const dim3 grid((rows + C::kM - 1) / C::kM, b * p.h);
  void* args[] = {(void*)&p, &maps[0], &maps[1], &maps[2], &maps[3], &maps[4], &maps[5]};
  return launch_status(cudaLaunchKernel(kernel_of(kind, p.d), grid, dim3(C::kThreads), args, C::bytes(dkv), stream));
}

int launch(int kind, const Params& p, int b, int rows, cudaStream_t stream) {
  if (!takes(p.d)) return (int)cudaErrorInvalidValue;
  const int err = configure(kind, p.d);
  if (err) return err;
  if (wide(p.d)) return launch_wide(kind, p, b, rows, stream);
  if (mma_body(kind, p.d)) {
    const dim3 grid((rows + kTile - 1) / kTile, b * p.h);
    void* args[] = {(void*)&p};
    return launch_status(
        cudaLaunchKernel(kernel_of(kind, p.d), grid, dim3(kThreads), args, smem_bytes(kind, p.d), stream));
  }
  const int bk = bucket(p.d);
  if (kind == kDkv)
    return bk == 0 ? launch_tf32<DkvB0>(kind, p, b, rows, stream) : launch_tf32<DkvB1>(kind, p, b, rows, stream);
  return bk == 0   ? launch_tf32<DqB0>(kind, p, b, rows, stream)
         : bk == 1 ? launch_tf32<DqB1>(kind, p, b, rows, stream)
                   : launch_tf32<DqB2>(kind, p, b, rows, stream);
}

int launch_wide_bf16(int kind, const Params& p, int b, int rows, cudaStream_t stream) {
  if (!takes(p.d) || p.d <= kStagedMaxD) return (int)cudaErrorInvalidValue;
  const int err = configure_bf16(kind);
  if (err) return err;
  dim3 grid((rows + kWideRows - 1) / kWideRows, b * p.h, grid_z(p.d));
  void* args[] = {(void*)&p};
  return launch_status(
      cudaLaunchKernel(wide_bf16_of(kind), grid, dim3(kBThreads), args, bf16_smem_bytes(kind, p.d), stream));
}

}  // namespace

extern "C" {

const char* ff_flash_bwd_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// What one block of kernel `kind` (0 dQ, 1 dK/dV; 2 and 3 the same past
// head_dim 256 for bf16) at head_dim d takes and how many fit an SM: out =
// {registers per thread, local (spill) bytes per thread, dynamic shared
// bytes, threads, blocks per SM}.
int ff_flash_bwd_occupancy(int kind, int d, int* out) {
  if (kind < 0 || kind > 3 || !takes(d) || (kind > 1 && d <= kStagedMaxD)) return (int)cudaErrorInvalidValue;
  const int k = kind & 1;
  if (kind > 1) {
    const int err = configure_bf16(k);
    if (err) return err;
    return flash::occupancy(wide_bf16_of(k), bf16_smem_bytes(k, d), out, kBThreads);
  }
  const int err = configure(k, d);
  if (err) return err;
  return flash::occupancy(kernel_of(k, d), smem_bytes(k, d), out, threads_of(k, d));
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
