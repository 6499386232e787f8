// Split-KV verify and decode attention against the serving KV cache, for
// Hopper (sm_90a): the device body of kernels #4-#9 at head_dim <= 256.
// Built by flexflow_tpu_torch/ops/cuda/_build.py with nvcc into a shared
// library with a plain C interface, loaded through ctypes by
// flexflow_tpu_torch/ops/cuda/decode_kernel.py.
//
// What it replaces: six Pallas TPU kernels of
// flexflow_tpu/ops/pallas/decode_kernel.py, one body templated on q's
// element type TQ (float, or __nv_bfloat16 under a mixed-precision model)
// and three flags:
//   kPaged kQuant kStair
//     0      0      0    _tree_kernel :626 (flash_verify_tree)            #7
//     1      0      0    _paged_tree_kernel :732 (paged_flash_verify_tree) #8
//     1      1      0    _paged_tree_kernel_quant :849                    #9
//     0      0      1    _decode_kernel :235 (flash_verify)               #4
//     1      0      1    _paged_kernel :342 (paged_flash_verify)          #5
//     1      1      1    _paged_kernel_quant :476                         #6
// (decode_kernel.cu's body serves all six past head_dim 256, where the
// wrapper routes them by head_dim alone.)
// w query rows per sequence against the cache, where row j sees position p
// iff allowed[b, j, p] != 0 (a uint8 mask over logical positions; the
// tree verifies) or p <= lengths[b] + j (kStair: the staircase of decode
// and linear verify, no mask read), and p < lengths[b] + w (the chunk
// gate). On the paged layout rows on a sentinel page (table entry outside
// [0, num_pages)) are neither read nor counted. kQuant: the pools are int8
// with one fp32 scale per (page, head); each row is read with 16-byte
// loads and multiplied by its page's scale on the way into the fp32 tile,
// as the reference dequantizes (attention._dequant_pages), so the staged
// values are bit-identical to the dense dequant; a page with scale 0
// reads as zeros; a row whose int8 elements are not 16-byte aligned
// (head_dim 24, 40, ...: an odd number of 8-byte words) is read in 8-byte
// loads instead, so any head_dim that is a multiple of 8 is taken. A masked
// entry contributes p = 0, and a row that sees nothing yields
// acc / max(l, 1e-30) = 0.
// bf16 q (TQ = __nv_bfloat16): the pools stay fp32 or int8, as the
// reference's cache does under allow_mixed_precision. Only two places
// change: q is widened to fp32 as it is loaded (exact), and the output is
// rounded to nearest even as it is written (the single-block finish, the
// one-row finish and the split merge), the reference's
// .astype(o_ref.dtype) (decode_kernel.py:229). The scores, P (the V pool's
// dtype, :218, fp32 here), the running (m, l), the accumulators and the
// partials stay fp32, so a bf16-q call computes the fp32-q function of the
// widened q and rounds it once.
//
// What bounds it: the bytes of the visible K/V rows. At the serving shape
// (8 sequences x 16 heads x 64, w = 13, max_len 512) the two products are
// under 0.25 GFLOP, a few microseconds at the card's fp32 rate, against
// ~6 us to read the fp32 rows once, so the design is about spreading the
// reads over the whole card and keeping the arithmetic off shared-memory
// round trips:
//   * split-KV (flash-decoding): the grid is (splits, h, b); each block owns
//     `span` consecutive positions (a multiple of 64 and a whole number of
//     pages, at most 64 splits: decode_kernel.py's _TREE_SPAN_UNIT and
//     _TREE_MAX_SPLITS, which pick_splits keeps and kSpanUnit and
//     kMaxSplits here enforce; 128 for #6 at w = 1, _QUANT_SPAN_UNIT),
//     chosen on the host from the shape alone so that the grid fills the
//     SMs several times over; `lengths`
//     stays on the device,
//     and a block whose range starts at or past min(lengths[b] + w,
//     max_len) exits at once; the split index is the fastest grid index,
//     so such blocks free their slots as soon as they are scheduled and
//     every block with positions to read can be resident at once;
//   * each block keeps its running (m, l) per query row and an fp32
//     accumulator in registers (fp64 in #9's tile at w <= 16: see Accum
//     below); where a sequence has one live split its
//     block writes the output, else each live block writes one partial
//     per query row and counts its arrival on the (sequence, head)'s
//     counter (atomicInc, which returns the counter to 0 as the last one
//     arrives, so it is zero again for the next call); the last to arrive
//     merges the partials exactly, M = max m_s, out = sum e^(m_s - M)
//     acc_s / max(sum e^(m_s - M) l_s, 1e-30), over the partials with
//     l_s > 0 only, so all-masked ranges drop out and a row that sees
//     nothing gives 0 with no NaN. Empty blocks exit at once: one launch
//     per call, no merge kernel;
//   * register tiling (tree_attention_kernel, w > 1, and every tree): 128
//     threads as 8 x 16; thread (ty, tx) owns query rows ty + 8 i (kRm of
//     them, the w bucket: w <= 16, 32 or 64) and key
//     rows tx + 16 j of each chunk (32 rows at w <= 16 or head_dim > 128,
//     else 64) for the scores (dot products over head_dim straight from
//     shared memory, no shuffles), and the same query rows times head_dim
//     columns 4 tx + 64 k (kCn of them: head_dim <= 64, 128 or 256) of the
//     accumulator, so each staged V element is loaded once per thread and
//     used for all of its rows; the row max and sum reduce across the 16 threads that
//     share a row;
//   * Q, K, V and the mask are staged with 16-byte (mask: 4-byte; bf16 q
//     and int8 rows not 16-byte aligned: 8-byte) loads;
//     rows are padded to head_dim + 4 floats against bank conflicts; each
//     row's cache offset (and page scale) is resolved once per chunk (one
//     page lookup per row, not per element); the length, the first chunk's
//     page lookups and the Q tile are loaded together, and the mask words
//     before K/V are stored, so a block waits on device memory twice per
//     chunk, not four times; shared memory is 26 KB per block at w <= 16,
//     head_dim 64, so 8 blocks share an SM;
//   * one query row of fp32 rows (single_query_kernel, #4 and #5 at
//     w = 1: every decode step): the 8 x 16 tile would leave 7 of its 8
//     query rows empty, so the 128 threads go across key rows and
//     head_dim instead. Half-warp
//     ty reads positions lo + ty + 8 i, lane tx head_dim columns
//     4 tx + 64 k, straight from device memory into registers (4 rows per
//     half-warp in flight at head_dim <= 64, 8 / kCn above: a 32- or
//     16-row pass; 8 rows at head_dim 64 took 126 registers and 16% more
//     time, 50% more at short contexts); each score
//     is reduced across the half-warp's 16 lanes with shuffles, and each
//     half-warp keeps its own running (m, l, acc), so the loop has no
//     barrier and no shared memory; the block merges its 8 states by the
//     same exact rule as the splits, then writes the output or its
//     partial;
//   * one query row of int8 rows (single_query_int8_kernel, #6 at w = 1):
//     a 64-column int8 row is 64 bytes, so 4 lanes cover it with one
//     16-byte load each (4 kCn lanes at wider heads) and the 128 threads
//     hold 32 rows at once, where the fp32 tile holds 8; row group g reads
//     positions lo + g + 32 i (2 rows per group in flight: a 64-row pass
//     at head_dim <= 64), keeps the raw rows (4 registers per 16
//     columns) until each is used and multiplies by the page's scale
//     right before (bit-identical to the plain dequant); each score is
//     four 4-term partials summed pairwise, then 2 shuffles (log2 of the
//     lanes per row); each group keeps its own running (m, l, acc), the
//     groups of a warp merge by shuffles and the block's 4 warps through
//     shared memory, by the same exact rule. Like the fp32 tile it is
//     bound by its chain of dependent waits (page lookup, rows, partial,
//     arrival, merge), not by bytes, so its spans are longer (128
//     positions: 4 splits at max_len 512, 2 passes each); on one H100,
//     4 rows per group took 0.0102-0.0106 ms at the serving shape and
//     0.0063 at short contexts against 0.0106 and 0.0047, the char4
//     columns of the fp32 tile 0.0152 (PERF.md, scripts/decode_split_body.py).
// Left to later work: the tile stages a chunk and then computes it, and
// the blocks of an SM do so in step; double-buffered cp.async staging
// would overlap the two.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTx = 16;                // threads across key rows / head_dim
constexpr int kTy = kThreads / kTx;    // threads across query rows
constexpr int kSpanUnit = 64;          // a split's span is a multiple of it
constexpr float kMask = -1e30f;
constexpr int kMaxSplits = 64;         // the merge weights fit the K/V tiles

struct Params {
  const void* q;            // float or __nv_bfloat16 (TQ)
  const void* k;            // float, or int8_t under kQuant
  const void* v;
  const float* k_scale;     // quant only: [num_pages, h] contiguous
  const float* v_scale;
  const int* lengths;
  const int* tables;        // paged only: [b, pages_per_seq] page ids
  const uint8_t* allowed;   // tree only: [b, w, max_len], last dim contiguous
  void* out;                // [b, w, h, d] contiguous, q's element type
  float* part_acc;          // splits > 1: [b, h, splits, w, d]
  float* part_ml;           // splits > 1: [b, h, splits, w, 2] (m, l)
  unsigned int* counters;   // splits > 1: [b * h] arrivals, zero at rest
  int w, h, d;
  int max_len;    // positions a sequence can hold
  int span;       // positions per split, a multiple of kSpanUnit
  int splits;
  int page_size;  // paged only
  int num_pages;  // paged only: entries outside [0, num_pages) are sentinels
  int mask_vec4;  // the mask rows may be read as 4-byte words
  int vec16;      // quant: the int8 rows are 16-byte aligned (else 8-byte loads)
  int64_t tbl_sb;
  int64_t q_sb, q_sw, q_sh;
  // contiguous: (batch, position, head) strides; paged: (page, row, head);
  // in elements of the cache's type
  int64_t k_s0, k_s1, k_sh;
  int64_t v_s0, v_s1, v_sh;
  int64_t m_sb, m_sw;
  float scale;
};

__host__ __device__ constexpr int row_stride(int cn) { return 64 * cn + 4; }

// The type the scores, the running (m, l) and the accumulator are summed
// in: fp64 for the int8 pools at w <= 16 (the spec path's tile), whose
// dequantized values reach 127 x scale, several times the fp32 caches':
// there fp32 sums over head_dim and over the chunk drift by ~4e-6 from
// exact, where the plain version's own rounding is ~8e-6
// (scripts/decode_split_body.py). Each 4-term partial (4 columns of a
// score, 4 key rows of P V) is still formed in fp32 and only the running
// sums are fp64: 2e-6 from exact at 30% more time than fp32 sums, where
// fp64 products cost 70%. fp32 elsewhere, where the wider tiles'
// registers hold no more.
template <bool kWide> struct Accum { using T = float; };
template <> struct Accum<true> { using T = double; };

// Key rows staged per loop iteration: 32 for w <= 16, where the smaller
// tiles let 8 blocks share an SM, so that every block of a call at the
// serving shape is resident at once, and for head_dim > 128, whose rows
// would otherwise not fit shared memory at w = 64; 64 for wider trees,
// whose tiles are the larger cost. Both divide kSpanUnit.
__host__ __device__ constexpr int chunk_rows(int rm, int cn) {
  return rm == 2 || cn == 4 ? 32 : 64;
}

__host__ __device__ constexpr size_t smem_bytes(int rm, int cn) {
  return sizeof(float) * (size_t)(rm * kTy * row_stride(cn) +
                                  2 * chunk_rows(rm, cn) * row_stride(cn) +
                                  rm * kTy * (chunk_rows(rm, cn) + 4) +
                                  2 * chunk_rows(rm, cn)) +
         2 * sizeof(int64_t) * chunk_rows(rm, cn) + (size_t)rm * kTy * chunk_rows(rm, cn);
}

// Element offsets of position `pos`'s K and V rows of head ih (head
// included) and, under kQuant, their page's scales; left as they are
// (-1, 0) where the row lies on a sentinel page.
template <bool kPaged, bool kQuant>
__device__ __forceinline__ void row_offsets(const Params& p, int ib, int ih, int pos,
                                            int64_t& ko, int64_t& vo, float& ks, float& vs) {
  if (kPaged) {
    const int page = p.tables[ib * p.tbl_sb + pos / p.page_size];
    if (page >= 0 && page < p.num_pages) {
      const int64_t row = pos % p.page_size;
      ko = page * p.k_s0 + row * p.k_s1 + ih * p.k_sh;
      vo = page * p.v_s0 + row * p.v_s1 + ih * p.v_sh;
      if (kQuant) {
        ks = p.k_scale[page * p.h + ih];
        vs = p.v_scale[page * p.h + ih];
      }
    }
  } else {
    ko = ib * p.k_s0 + pos * p.k_s1 + ih * p.k_sh;
    vo = ib * p.v_s0 + pos * p.v_s1 + ih * p.v_sh;
  }
}

// Called by every thread of a live block after it wrote its partials
// (rows base + is * w + j): counts the block's arrival on its (sequence,
// head)'s counter, and the last block to arrive merges the live partials
// (read from L2) into the output: the (m, l) of every (split, row) into
// `scratch` at once, then each row's weights e^(m_s - M) (0 where l_s =
// 0), then the accumulators. scratch holds 3 * kMaxSplits * w + w floats,
// 8-byte aligned; partial rows base + s * w + j of splits 0..live-1 are
// contiguous.
template <typename TQ>
__device__ void arrive_and_merge(const Params& p, int ib, int ih, int live, int64_t base,
                                 float* scratch) {
  const int tid = threadIdx.x, w = p.w, d4 = p.d / 4;
  __threadfence();
  __syncthreads();
  __shared__ int last_s;
  if (tid == 0)
    last_s = atomicInc(p.counters + ib * p.h + ih, (unsigned)(live - 1)) == (unsigned)(live - 1);
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  float2* ml_s = reinterpret_cast<float2*>(scratch);              // [live * w]
  float* wt = reinterpret_cast<float*>(ml_s + kMaxSplits * w);     // [live * w]
  float* den = wt + kMaxSplits * w;                                // [w] max(sum e l, 1e-30)
  const float2* ml2 = reinterpret_cast<const float2*>(p.part_ml) + base;
  for (int i = tid; i < live * w; i += kThreads) ml_s[i] = __ldcg(ml2 + i);
  __syncthreads();
  for (int j = tid; j < w; j += kThreads) {
    float m = kMask;
    for (int s = 0; s < live; ++s)
      if (ml_s[s * w + j].y > 0.f) m = fmaxf(m, ml_s[s * w + j].x);
    float sum = 0.f;
    for (int s = 0; s < live; ++s) {
      const float2 x = ml_s[s * w + j];
      const float e = x.y > 0.f ? expf(x.x - m) : 0.f;
      wt[s * w + j] = e;
      sum += e * x.y;
    }
    den[j] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  // every live block wrote its whole partial (zeros where it saw nothing),
  // so each load is of finite values; kBatch of them are issued before
  // the first is used
  constexpr int kBatch = 8;
  const float4* acc4 = reinterpret_cast<const float4*>(p.part_acc) + base * d4;
  TQ* out = static_cast<TQ*>(p.out);
  for (int i = tid; i < w * d4; i += kThreads) {
    const int j = i / d4, c = i - j * d4;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < live; s0 += kBatch) {
      float4 a[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        a[u] = s0 + u < live ? __ldcg(acc4 + (int64_t)((s0 + u) * w + j) * d4 + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float e = s0 + u < live ? wt[(s0 + u) * w + j] : 0.f;
        num.x += e * a[u].x;
        num.y += e * a[u].y;
        num.z += e * a[u].z;
        num.w += e * a[u].w;
      }
    }
    const float l = den[j];
    store4<TQ>(out + ((((int64_t)ib * w + j) * p.h + ih) * d4 + c) * 4,
               make_float4(num.x / l, num.y / l, num.z / l, num.w / l));
  }
}

template <typename TQ, bool kPaged, bool kQuant, bool kStair, int kRm, int kCn>
__global__ void __launch_bounds__(kThreads)
    tree_attention_kernel(const Params p) {
  using Acc = typename Accum<kQuant && kRm == 2>::T;
  constexpr int kWb = kRm * kTy;      // query rows of the tile
  constexpr int kChunk = chunk_rows(kRm, kCn);
  constexpr int kKn = kChunk / kTx;   // key rows per thread in the scores
  constexpr int kPs = kChunk + 4;     // padded row stride of the p tile
  constexpr int kDs = row_stride(kCn);
  constexpr int kC4 = 16 * kCn;       // float4 columns of a staged row
  constexpr int kRs = kThreads / kC4; // rows staged per pass
  constexpr int kC16 = 4 * kCn;       // 16-byte int8 columns of a staged row
  constexpr int kRs8 = kThreads / kC16;  // int8 rows staged per pass
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kWb][kDs]
  float* k_s = q_s + kWb * kDs;                  // [kChunk][kDs]
  float* v_s = k_s + kChunk * kDs;               // [kChunk][kDs]
  float* p_s = v_s + kChunk * kDs;               // [kWb][kPs]
  float* ks_s = p_s + kWb * kPs;                 // quant: [kChunk] page scales
  float* vs_s = ks_s + kChunk;
  // cache offsets of this chunk's rows (head included), -1 = not read
  int64_t* koff_s = reinterpret_cast<int64_t*>(vs_s + kChunk);
  int64_t* voff_s = koff_s + kChunk;
  uint8_t* vis_s = reinterpret_cast<uint8_t*>(voff_s + kChunk);  // tree: [kWb][kChunk]

  const int is = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;
  const int w = p.w, d = p.d, d4 = p.d / 4;
  const int lo = is * p.span;
  // the length, the first chunk's row offsets and the Q tile are loaded
  // together (the last two lie inside the cache whatever the length)
  const int length = p.lengths[ib];
  int64_t ko = -1, vo = -1;
  float ksc = 0.f, vsc = 0.f;
  if (tid < kChunk && lo + tid < p.max_len)
    row_offsets<kPaged, kQuant>(p, ib, ih, lo + tid, ko, vo, ksc, vsc);
  constexpr int kQn = kWb * kC4 / kThreads;  // Q float4s per thread
  float4 qv[kQn];
  const TQ* qb = static_cast<const TQ*>(p.q) + ib * p.q_sb + ih * p.q_sh;
#pragma unroll
  for (int u = 0; u < kQn; ++u) {
    const int i = tid + u * kThreads, j = i / kC4, c = i % kC4;
    qv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < w && c < d4) qv[u] = load4<TQ>(qb + j * p.q_sw + 4 * c);
  }
  // positions [0, end) are visible to at least one query row
  const int end = min(length + w, p.max_len);
  const int hi = min(lo + p.span, end);
  if (lo >= hi) {  // nothing to read in this range
    if (is == 0)  // nor in any (lengths[b] + w <= 0): the output is 0
      for (int i = tid; i < w * d; i += kThreads)
        static_cast<TQ*>(p.out)[(((int64_t)ib * w + i / d) * p.h + ih) * d + i % d] = from_f32<TQ>(0.f);
    return;
  }
  const int live = (end + p.span - 1) / p.span;  // splits with positions to read
#pragma unroll
  for (int u = 0; u < kQn; ++u) {
    const int i = tid + u * kThreads;
    reinterpret_cast<float4*>(q_s + (i / kC4) * kDs)[i % kC4] = qv[u];
  }

  Acc acc[kRm][4 * kCn];
  Acc m_r[kRm], l_r[kRm];
#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    m_r[i] = kMask;
    l_r[i] = 0;
#pragma unroll
    for (int e = 0; e < 4 * kCn; ++e) acc[i][e] = 0;
  }

  const int sc = tid % kC4, sr = tid / kC4;     // this thread's fp32 staging column, first row
  const int sc8 = tid % kC16, sr8 = tid / kC16;  // the same for 16-byte int8 loads
  constexpr int kC8 = 8 * kCn;         // 8-byte int8 columns of a staged row
  constexpr int kRs8h = kThreads / kC8;  // int8 rows staged per pass in 8-byte loads
  const int sc8h = tid % kC8, sr8h = tid / kC8;
  const uint8_t* mb = p.allowed + ib * p.m_sb;
  for (int k0 = lo; k0 < hi; k0 += kChunk) {
    const int rows = min(kChunk, hi - k0);
    // where each row of the chunk lives, or -1 (past the range or on a
    // sentinel page), and its page's scales
    if (tid < kChunk) {
      if (k0 != lo) {
        ko = vo = -1;
        ksc = vsc = 0.f;
        if (k0 + tid < p.max_len) row_offsets<kPaged, kQuant>(p, ib, ih, k0 + tid, ko, vo, ksc, vsc);
      }
      koff_s[tid] = tid < rows ? ko : -1;
      voff_s[tid] = tid < rows ? vo : -1;
      if (kQuant) {
        ks_s[tid] = tid < rows ? ksc : 0.f;
        vs_s[tid] = tid < rows ? vsc : 0.f;
      }
    }
    __syncthreads();

    // this chunk's mask words (tree), then K and V (zeros where a row is
    // not read, so p = 0 meets finite values), then the mask with the
    // page check folded in
    constexpr int kMw = kStair ? 1 : kWb * (kChunk / 4) / kThreads;  // mask words per thread
    uint32_t mw[kMw];
    if (!kStair) {
#pragma unroll
      for (int u = 0; u < kMw; ++u) {
        const int i = tid + u * kThreads;
        const int j = i / (kChunk / 4), c = 4 * (i % (kChunk / 4));
        uint32_t word = 0;
        if (j < w) {
          const uint8_t* mr = mb + j * p.m_sw + k0 + c;
          if (p.mask_vec4 && c + 4 <= rows) {
            word = *reinterpret_cast<const uint32_t*>(mr);
          } else {
            for (int e = 0; e < 4 && c + e < rows; ++e) word |= (uint32_t)mr[e] << (8 * e);
          }
        }
        mw[u] = word;
      }
    }
    if (kQuant && p.vec16) {
      const int8_t* k8 = static_cast<const int8_t*>(p.k);
      const int8_t* v8 = static_cast<const int8_t*>(p.v);
#pragma unroll
      for (int u = 0; u < kChunk / kRs8; ++u) {
        const int r = sr8 + u * kRs8;
        const int64_t ko = koff_s[r], vo = voff_s[r];
        int4 kr = make_int4(0, 0, 0, 0), vr = kr;
        if (ko >= 0 && 16 * sc8 < d) {
          kr = __ldg(reinterpret_cast<const int4*>(k8 + ko) + sc8);
          vr = __ldg(reinterpret_cast<const int4*>(v8 + vo) + sc8);
        }
        store_dequant(k_s + r * kDs + 16 * sc8, kr, ks_s[r]);
        store_dequant(v_s + r * kDs + 16 * sc8, vr, vs_s[r]);
      }
    } else if (kQuant) {  // rows 8-byte aligned only (head_dim 24, 40, ...)
      const int8_t* k8 = static_cast<const int8_t*>(p.k);
      const int8_t* v8 = static_cast<const int8_t*>(p.v);
#pragma unroll
      for (int u = 0; u < kChunk / kRs8h; ++u) {
        const int r = sr8h + u * kRs8h;
        const int64_t ko = koff_s[r], vo = voff_s[r];
        int2 kr = make_int2(0, 0), vr = kr;
        if (ko >= 0 && 8 * sc8h < d) {
          kr = __ldg(reinterpret_cast<const int2*>(k8 + ko) + sc8h);
          vr = __ldg(reinterpret_cast<const int2*>(v8 + vo) + sc8h);
        }
        store_dequant8(k_s + r * kDs + 8 * sc8h, kr, ks_s[r]);
        store_dequant8(v_s + r * kDs + 8 * sc8h, vr, vs_s[r]);
      }
    } else {
      const float* kf = static_cast<const float*>(p.k);
      const float* vf = static_cast<const float*>(p.v);
#pragma unroll
      for (int u = 0; u < kChunk / kRs; ++u) {
        const int r = sr + u * kRs;
        const int64_t ko = koff_s[r], vo = voff_s[r];
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
        if (ko >= 0 && sc < d4) {
          kv = __ldg(reinterpret_cast<const float4*>(kf + ko) + sc);
          vv = __ldg(reinterpret_cast<const float4*>(vf + vo) + sc);
        }
        reinterpret_cast<float4*>(k_s + r * kDs)[sc] = kv;
        reinterpret_cast<float4*>(v_s + r * kDs)[sc] = vv;
      }
    }
    if (!kStair) {
#pragma unroll
      for (int u = 0; u < kMw; ++u) {
        const int i = tid + u * kThreads;
        const int j = i / (kChunk / 4), c = 4 * (i % (kChunk / 4));
        uint32_t vis = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (((mw[u] >> (8 * e)) & 0xffu) && koff_s[c + e] >= 0) vis |= 1u << (8 * e);
        reinterpret_cast<uint32_t*>(vis_s + j * kChunk)[c / 4] = vis;
      }
    }
    __syncthreads();

    // scores of the thread's (query row, key row) micro-tile over head_dim
    Acc s[kRm][kKn];
#pragma unroll
    for (int i = 0; i < kRm; ++i)
#pragma unroll
      for (int j = 0; j < kKn; ++j) s[i][j] = 0;
    const float4* q4 = reinterpret_cast<const float4*>(q_s + ty * kDs);
    const float4* k4 = reinterpret_cast<const float4*>(k_s + tx * kDs);
#pragma unroll 4
    for (int c = 0; c < d4; ++c) {
      float4 kk[kKn];
#pragma unroll
      for (int j = 0; j < kKn; ++j) kk[j] = k4[j * kTx * (kDs / 4) + c];
#pragma unroll
      for (int i = 0; i < kRm; ++i) {
        const float4 qq = q4[i * kTy * (kDs / 4) + c];
#pragma unroll
        for (int j = 0; j < kKn; ++j)
          s[i][j] += (Acc)(qq.x * kk[j].x + qq.y * kk[j].y + qq.z * kk[j].z + qq.w * kk[j].w);
      }
    }

    // staircase: key row tx + 16 j is read (on a real page, inside the
    // range) and lies at or before lengths[b] + row
    bool on[kKn];
    if (kStair) {
#pragma unroll
      for (int j = 0; j < kKn; ++j) on[j] = koff_s[tx + j * kTx] >= 0;
    }
    const int stair0 = length - k0 - tx;  // + row - 16 j: the last visible key row's slack

    // online softmax per query row, reduced across the 16 threads of the row
#pragma unroll
    for (int i = 0; i < kRm; ++i) {
      const int row = ty + i * kTy;
      bool seen[kKn];
      Acc mx = kMask;
#pragma unroll
      for (int j = 0; j < kKn; ++j) {
        seen[j] = kStair ? on[j] && j * kTx <= stair0 + row
                         : vis_s[row * kChunk + tx + j * kTx] != 0;
        s[i][j] = seen[j] ? s[i][j] * p.scale : (Acc)kMask;
        mx = max(mx, s[i][j]);
      }
#pragma unroll
      for (int o = kTx / 2; o > 0; o >>= 1)
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const Acc m_new = max(m_r[i], mx);
      const Acc corr = expf((float)(m_r[i] - m_new));
      Acc sum = 0;
#pragma unroll
      for (int j = 0; j < kKn; ++j) {
        const float pr = seen[j] ? expf((float)(s[i][j] - m_new)) : 0.f;
        p_s[row * kPs + tx + j * kTx] = pr;
        sum += pr;
      }
#pragma unroll
      for (int o = kTx / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_r[i] = l_r[i] * corr + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * kCn; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

    // acc += p @ V: four key rows per step, each V float4 used for all rows
    const int rows4 = (rows + 3) & ~3;
    for (int r = 0; r < rows4; r += 4) {
      float4 pp[kRm];
#pragma unroll
      for (int i = 0; i < kRm; ++i)
        pp[i] = *reinterpret_cast<const float4*>(p_s + (ty + i * kTy) * kPs + r);
#pragma unroll
      for (int k = 0; k < kCn; ++k) {
        const float* vr = v_s + r * kDs + 4 * tx + 64 * k;
        const float4 v0 = *reinterpret_cast<const float4*>(vr);
        const float4 v1 = *reinterpret_cast<const float4*>(vr + kDs);
        const float4 v2 = *reinterpret_cast<const float4*>(vr + 2 * kDs);
        const float4 v3 = *reinterpret_cast<const float4*>(vr + 3 * kDs);
#pragma unroll
        for (int i = 0; i < kRm; ++i) {
          const float px = pp[i].x, py = pp[i].y, pz = pp[i].z, pw = pp[i].w;
          acc[i][4 * k] += (Acc)(px * v0.x + py * v1.x + pz * v2.x + pw * v3.x);
          acc[i][4 * k + 1] += (Acc)(px * v0.y + py * v1.y + pz * v2.y + pw * v3.y);
          acc[i][4 * k + 2] += (Acc)(px * v0.z + py * v1.z + pz * v2.z + pw * v3.z);
          acc[i][4 * k + 3] += (Acc)(px * v0.w + py * v1.w + pz * v2.w + pw * v3.w);
        }
      }
    }
    __syncthreads();
  }

  if (live == 1) {  // the only split with positions: the output itself
#pragma unroll
    for (int i = 0; i < kRm; ++i) {
      const int row = ty + i * kTy;
      if (row >= w) continue;
      const Acc l = max(l_r[i], (Acc)1e-30f);
      TQ* o = static_cast<TQ*>(p.out) + (((int64_t)ib * w + row) * p.h + ih) * d;
#pragma unroll
      for (int k = 0; k < kCn; ++k) {
        const int c = 4 * tx + 64 * k;
        if (c < d)
          store4<TQ>(o + c, make_float4(acc[i][4 * k] / l, acc[i][4 * k + 1] / l,
                                        acc[i][4 * k + 2] / l, acc[i][4 * k + 3] / l));
      }
    }
    return;
  }

  // a partial per query row, then the arrival count and the merge (its
  // scratch in the Q, K and V tiles)
  const int64_t base = (int64_t)(ib * p.h + ih) * p.splits * w;  // split 0, row 0
#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int row = ty + i * kTy;
    if (row >= w) continue;
    const int64_t r = base + (int64_t)is * w + row;
    float* o = p.part_acc + r * d;
#pragma unroll
    for (int k = 0; k < kCn; ++k) {
      const int c = 4 * tx + 64 * k;
      if (c < d)
        *reinterpret_cast<float4*>(o + c) =
            make_float4(acc[i][4 * k], acc[i][4 * k + 1], acc[i][4 * k + 2], acc[i][4 * k + 3]);
    }
    if (tx == 0) {
      p.part_ml[2 * r] = m_r[i];
      p.part_ml[2 * r + 1] = l_r[i];
    }
  }
  static_assert(3 * kMaxSplits * kWb + kWb <= kWb * kDs + 2 * kChunk * kDs + kWb * kPs,
                "the merge's scratch does not fit the tiles");
  arrive_and_merge<TQ>(p, ib, ih, live, base, q_s);
}

// The end of a one-row tile (w = 1): its kN partial states (acc_s[t], the
// accumulator over head_dim; ml_s[t] = (m, l)), stored and followed by a
// barrier, merged exactly as the splits are; then the output where this
// is the only live split, else this split's partial, its arrival and the
// merge (arrive_and_merge, its scratch in the tile's own shared memory).
template <typename TQ, int kN, int kC4>
__device__ void finish_single_row(const Params& p, int ib, int ih, int is, int live,
                                  const float4 (&acc_s)[kN][kC4], const float2 (&ml_s)[kN]) {
  __shared__ float2 scratch2[(3 * kMaxSplits + 2) / 2];  // the merge's, w = 1
  const int tid = threadIdx.x, d4 = p.d / 4;
  float big = kMask;
#pragma unroll
  for (int t = 0; t < kN; ++t)
    if (ml_s[t].y > 0.f) big = fmaxf(big, ml_s[t].x);
  float e[kN], den = 0.f;
#pragma unroll
  for (int t = 0; t < kN; ++t) {
    e[t] = ml_s[t].y > 0.f ? expf(ml_s[t].x - big) : 0.f;
    den += e[t] * ml_s[t].y;
  }
  const float inv = live == 1 ? 1.f / fmaxf(den, 1e-30f) : 1.f;
  // live == 1: the output; else this split's partial (M, L, acc)
  const int64_t base = (int64_t)(ib * p.h + ih) * p.splits;  // split 0
  TQ* out = static_cast<TQ*>(p.out) + ((int64_t)ib * p.h + ih) * p.d;
  float4* part = reinterpret_cast<float4*>(p.part_acc) + (base + is) * d4;
  for (int c = tid; c < d4; c += kThreads) {
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int t = 0; t < kN; ++t) {
      const float4 a = acc_s[t][c];
      num.x += e[t] * a.x;
      num.y += e[t] * a.y;
      num.z += e[t] * a.z;
      num.w += e[t] * a.w;
    }
    if (live == 1)
      store4<TQ>(out + 4 * c, make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv));
    else
      part[c] = num;
  }
  if (live == 1) return;
  if (tid == 0) {
    p.part_ml[2 * (base + is)] = big;
    p.part_ml[2 * (base + is) + 1] = den;
  }
  arrive_and_merge<TQ>(p, ib, ih, live, base, reinterpret_cast<float*>(scratch2));
}

// One query row of fp32 rows under the staircase (w = 1: position p
// visible iff p <= lengths[b]; #4 and #5): see the header. Half-warp ty
// holds positions k0 + ty + 8 i of each pass, lane tx head_dim columns
// 4 tx + 64 k.
template <typename TQ, bool kPaged, int kCn>
__global__ void __launch_bounds__(kThreads)
    single_query_kernel(const Params p) {
  constexpr int kR = kCn == 1 ? 4 : 8 / kCn;  // positions per half-warp per pass
  constexpr int kPass = kTy * kR;    // positions per pass: 32, 32 or 16
  __shared__ float4 acc_s[kTy][16 * kCn];  // each half-warp's accumulator
  __shared__ float2 ml_s[kTy];             // and its (m, l)

  const int is = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;
  const int d = p.d, d4 = p.d / 4;
  const float* kf = static_cast<const float*>(p.k);
  const float* vf = static_cast<const float*>(p.v);
  const int lo = is * p.span;
  // the length, the first pass's row offsets and q are loaded together
  const int length = p.lengths[ib];
  int64_t ko[kR], vo[kR];
  float unused = 0.f;  // the scales row_offsets sets under kQuant only
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    ko[i] = vo[i] = -1;
    const int pos = lo + ty + kTy * i;
    if (pos < p.max_len) row_offsets<kPaged, false>(p, ib, ih, pos, ko[i], vo[i], unused, unused);
  }
  float4 qv[kCn];
  const TQ* qb = static_cast<const TQ*>(p.q) + ib * p.q_sb + ih * p.q_sh;
#pragma unroll
  for (int k = 0; k < kCn; ++k) {
    const int c = tx + 16 * k;
    qv[k] = c < d4 ? load4<TQ>(qb + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int end = min(length + 1, p.max_len);  // positions [0, end) are visible
  const int hi = min(lo + p.span, end);
  if (lo >= hi) {  // nothing to read in this range
    if (is == 0)  // nor in any (lengths[b] < 0): the output is 0
      for (int c = tid; c < d; c += kThreads)
        static_cast<TQ*>(p.out)[((int64_t)ib * p.h + ih) * d + c] = from_f32<TQ>(0.f);
    return;
  }
  const int live = (end + p.span - 1) / p.span;  // splits with positions to read

  float m = kMask, l = 0.f;
  float acc[4 * kCn];
#pragma unroll
  for (int e = 0; e < 4 * kCn; ++e) acc[e] = 0.f;
  for (int k0 = lo; k0 < hi; k0 += kPass) {
    if (k0 != lo) {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        ko[i] = vo[i] = -1;
        const int pos = k0 + ty + kTy * i;
        if (pos < hi) row_offsets<kPaged, false>(p, ib, ih, pos, ko[i], vo[i], unused, unused);
      }
    }
    // every read of the pass in flight at once
    bool seen[kR];
    float4 kk[kR][kCn], vv[kR][kCn];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      seen[i] = k0 + ty + kTy * i < hi && ko[i] >= 0;
#pragma unroll
      for (int k = 0; k < kCn; ++k) {
        const int c = tx + 16 * k;
        kk[i][k] = vv[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (seen[i] && c < d4) {
          kk[i][k] = __ldg(reinterpret_cast<const float4*>(kf + ko[i]) + c);
          vv[i][k] = __ldg(reinterpret_cast<const float4*>(vf + vo[i]) + c);
        }
      }
    }
    float s[kR];
    float mx = kMask;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < kCn; ++k)
        dot += qv[k].x * kk[i][k].x + qv[k].y * kk[i][k].y + qv[k].z * kk[i][k].z + qv[k].w * kk[i][k].w;
#pragma unroll
      for (int o = kTx / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[i] = seen[i] ? dot * p.scale : kMask;
      mx = fmaxf(mx, s[i]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * kCn; ++e) acc[e] *= corr;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float pr = seen[i] ? expf(s[i] - m_new) : 0.f;
      sum += pr;
#pragma unroll
      for (int k = 0; k < kCn; ++k) {
        acc[4 * k] += pr * vv[i][k].x;
        acc[4 * k + 1] += pr * vv[i][k].y;
        acc[4 * k + 2] += pr * vv[i][k].z;
        acc[4 * k + 3] += pr * vv[i][k].w;
      }
    }
    l = l * corr + sum;
    m = m_new;
  }

  // the block's 8 half-warp states
#pragma unroll
  for (int k = 0; k < kCn; ++k)
    acc_s[ty][tx + 16 * k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
  if (tx == 0) ml_s[ty] = make_float2(m, l);
  __syncthreads();
  finish_single_row<TQ>(p, ib, ih, is, live, acc_s, ml_s);
}

// 16 int8 values times their page's scale, dotted with 16 fp32 values:
// four 4-term partials, summed pairwise
__device__ __forceinline__ float dot16(const float4 (&q)[4], int4 raw, float s) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  float part[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    part[u] = q[u].x * ((float)b[4 * u] * s) + q[u].y * ((float)b[4 * u + 1] * s) +
              q[u].z * ((float)b[4 * u + 2] * s) + q[u].w * ((float)b[4 * u + 3] * s);
  return (part[0] + part[1]) + (part[2] + part[3]);
}

// One query row of int8 rows under the staircase (#6 at w = 1): see the
// header. Row group g (kL consecutive lanes) holds positions k0 + g + kG i
// of each pass, lane t of the group int8 columns 16 t .. 16 t + 15 as one
// 16-byte load.
template <typename TQ, int kCn>
__global__ void __launch_bounds__(kThreads)
    single_query_int8_kernel(const Params p) {
  constexpr int kL = 4 * kCn;          // lanes per row
  constexpr int kG = kThreads / kL;    // row groups: 32, 16 or 8
  constexpr int kR = 2;                // positions per group per pass
  constexpr int kPass = kG * kR;       // positions per pass
  constexpr int kWarps = kThreads / 32;
  __shared__ float4 acc_s[kWarps][16 * kCn];  // each warp's accumulator
  __shared__ float2 ml_s[kWarps];             // and its (m, l)

  const int is = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x, t = tid % kL, g = tid / kL, warp = tid / 32;
  const int d = p.d;
  const bool cols = 16 * t < d;  // this lane's 16 columns lie inside head_dim
  const int8_t* k8 = static_cast<const int8_t*>(p.k);
  const int8_t* v8 = static_cast<const int8_t*>(p.v);
  const int lo = is * p.span;
  // the length, the first pass's row offsets and q are loaded together
  const int length = p.lengths[ib];
  int64_t ko[kR], vo[kR];
  float ks[kR], vs[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    ko[i] = vo[i] = -1;
    ks[i] = vs[i] = 0.f;
    const int pos = lo + g + kG * i;
    if (pos < p.max_len) row_offsets<true, true>(p, ib, ih, pos, ko[i], vo[i], ks[i], vs[i]);
  }
  const bool hi8 = 16 * t + 8 < d;  // and its upper 8 columns too (head_dim 24, 40, ...)
  float4 qv[4];
  const TQ* qb = static_cast<const TQ*>(p.q) + ib * p.q_sb + ih * p.q_sh;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    qv[u] = 16 * t + 4 * u < d ? load4<TQ>(qb + 16 * t + 4 * u) : make_float4(0.f, 0.f, 0.f, 0.f);
  const int end = min(length + 1, p.max_len);  // positions [0, end) are visible
  const int hi = min(lo + p.span, end);
  if (lo >= hi) {  // nothing to read in this range
    if (is == 0)  // nor in any (lengths[b] < 0): the output is 0
      for (int c = tid; c < d; c += kThreads)
        static_cast<TQ*>(p.out)[((int64_t)ib * p.h + ih) * d + c] = from_f32<TQ>(0.f);
    return;
  }
  const int live = (end + p.span - 1) / p.span;  // splits with positions to read

  float m = kMask, l = 0.f;
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  for (int k0 = lo; k0 < hi; k0 += kPass) {
    if (k0 != lo) {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        ko[i] = vo[i] = -1;
        ks[i] = vs[i] = 0.f;
        const int pos = k0 + g + kG * i;
        if (pos < hi) row_offsets<true, true>(p, ib, ih, pos, ko[i], vo[i], ks[i], vs[i]);
      }
    }
    // every read of the pass in flight at once, kept raw (4 registers per
    // 16 columns) until used
    bool seen[kR];
    int4 kr[kR], vr[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      seen[i] = k0 + g + kG * i < hi && ko[i] >= 0;
      kr[i] = vr[i] = make_int4(0, 0, 0, 0);
      if (seen[i] && cols) {
        if (p.vec16) {
          kr[i] = __ldg(reinterpret_cast<const int4*>(k8 + ko[i]) + t);
          vr[i] = __ldg(reinterpret_cast<const int4*>(v8 + vo[i]) + t);
        } else {  // two 8-byte loads, the second inside head_dim only
          const int2 klo = __ldg(reinterpret_cast<const int2*>(k8 + ko[i]) + 2 * t);
          const int2 vlo = __ldg(reinterpret_cast<const int2*>(v8 + vo[i]) + 2 * t);
          const int2 khi = hi8 ? __ldg(reinterpret_cast<const int2*>(k8 + ko[i]) + 2 * t + 1) : make_int2(0, 0);
          const int2 vhi = hi8 ? __ldg(reinterpret_cast<const int2*>(v8 + vo[i]) + 2 * t + 1) : make_int2(0, 0);
          kr[i] = make_int4(klo.x, klo.y, khi.x, khi.y);
          vr[i] = make_int4(vlo.x, vlo.y, vhi.x, vhi.y);
        }
      }
    }
    float s[kR];
    float mx = kMask;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float dot = dot16(qv, kr[i], ks[i]);
#pragma unroll
      for (int o = kL / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[i] = seen[i] ? dot * p.scale : kMask;
      mx = fmaxf(mx, s[i]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] *= corr;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float pr = seen[i] ? expf(s[i] - m_new) : 0.f;
      sum += pr;
      const int4 raw = vr[i];
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] += pr * ((float)b[e] * vs[i]);
    }
    l = l * corr + sum;
    m = m_new;
  }

  // the warp's kG / kWarps row groups merged by shuffles (lanes t of
  // every group hold the same columns), exactly as the splits are: a group
  // that saw nothing has m = kMask and l = acc = 0, so its weight is 0
  // wherever another group saw something
  float wm = m;
#pragma unroll
  for (int o = kL; o < 32; o <<= 1) wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, o));
  const float ew = expf(m - wm);
  float wl = l * ew;
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] *= ew;
#pragma unroll
  for (int o = kL; o < 32; o <<= 1) {
    wl += __shfl_xor_sync(0xffffffffu, wl, o);
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (tid % 32 < kL) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      acc_s[warp][4 * t + u] = make_float4(acc[4 * u], acc[4 * u + 1], acc[4 * u + 2], acc[4 * u + 3]);
    if (t == 0) ml_s[warp] = make_float2(wm, wl);
  }
  __syncthreads();
  finish_single_row<TQ>(p, ib, ih, is, live, acc_s, ml_s);  // the block's 4 warp states
}

template <typename TQ, bool kPaged, bool kQuant, bool kStair, int kRm, int kCn>
int launch_tile(const Params& p, int b, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(kRm, kCn);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        tree_attention_kernel<TQ, kPaged, kQuant, kStair, kRm, kCn>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)  // all of the SM's L1/shared split to shared: more blocks
      e = cudaFuncSetAttribute(tree_attention_kernel<TQ, kPaged, kQuant, kStair, kRm, kCn>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid(p.splits, p.h, b);
  tree_attention_kernel<TQ, kPaged, kQuant, kStair, kRm, kCn><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename TQ, bool kPaged, bool kQuant, bool kStair, int kRm>
int launch_cols(const Params& p, int b, cudaStream_t stream) {
  if (p.d <= 64) return launch_tile<TQ, kPaged, kQuant, kStair, kRm, 1>(p, b, stream);
  if (p.d <= 128) return launch_tile<TQ, kPaged, kQuant, kStair, kRm, 2>(p, b, stream);
  return launch_tile<TQ, kPaged, kQuant, kStair, kRm, 4>(p, b, stream);
}

template <typename TQ, bool kPaged, bool kQuant, int kCn>
int launch_single(const Params& p, int b, cudaStream_t stream) {
  dim3 grid(p.splits, p.h, b);
  if constexpr (kQuant)
    single_query_int8_kernel<TQ, kCn><<<grid, kThreads, 0, stream>>>(p);
  else
    single_query_kernel<TQ, kPaged, kCn><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename TQ, bool kPaged, bool kQuant, bool kStair>
int launch_bucket(const Params& p, int b, cudaStream_t stream) {
  if constexpr (kStair) {
    if (p.w == 1) {
      if (p.d <= 64) return launch_single<TQ, kPaged, kQuant, 1>(p, b, stream);
      if (p.d <= 128) return launch_single<TQ, kPaged, kQuant, 2>(p, b, stream);
      return launch_single<TQ, kPaged, kQuant, 4>(p, b, stream);
    }
  }
  if (p.w <= 2 * kTy) return launch_cols<TQ, kPaged, kQuant, kStair, 2>(p, b, stream);
  if (p.w <= 4 * kTy) return launch_cols<TQ, kPaged, kQuant, kStair, 4>(p, b, stream);
  return launch_cols<TQ, kPaged, kQuant, kStair, 8>(p, b, stream);
}

template <typename TQ>
int launch_variant(int variant, const Params& p, int b, cudaStream_t s) {
  switch (variant) {
    case 0: return launch_bucket<TQ, false, false, false>(p, b, s);  // #7
    case 4: return launch_bucket<TQ, true, false, false>(p, b, s);   // #8
    case 6: return launch_bucket<TQ, true, true, false>(p, b, s);    // #9
    case 1: return launch_bucket<TQ, false, false, true>(p, b, s);   // #4
    case 5: return launch_bucket<TQ, true, false, true>(p, b, s);    // #5
    case 7: return launch_bucket<TQ, true, true, true>(p, b, s);     // #6
    default: return (int)cudaErrorInvalidValue;  // int8 needs the paged layout
  }
}

}  // namespace

extern "C" {

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Verify or decode attention on the split-KV body. q [b, w, h, d] fp32, or
// bf16 with q_bf16 != 0 (head_dim contiguous, rows 4-element aligned); out
// [b, w, h, d] contiguous in q's type; lengths [b] int32.
// Contiguous layout (paged == 0): k/v [b, max_len, h, d], strides (batch,
// position, head). Paged: k/v [num_pages, page_size, h, d], strides (page,
// row, head) in elements, tables [b, max_len / page_size] int32 with
// entries outside [0, num_pages) unallocated. quant != 0 (paged only):
// k/v int8 with k_scale/v_scale [num_pages, h] contiguous fp32, head_dim a
// multiple of 8, rows read in 16-byte loads where vec16 != 0 (head_dim a
// multiple of 16 and the rows 16-byte aligned), else in 8-byte loads (rows
// 8-byte aligned); else fp32. stair != 0: the staircase p <= lengths[b] + j
// and allowed unused; else allowed [b, w, max_len] uint8 with strides
// (m_sb, m_sw), nonzero = visible. head_dim is a multiple of 4 up to 256.
// splits x span cover max_len, span a multiple of kSpanUnit (and of
// page_size when paged), splits at most kMaxSplits; with splits > 1,
// part_acc holds b * h * splits * w * d floats, part_ml b * h * splits * w
// * 2, and counters b * h unsigned ints that are zero (the launch leaves
// them zero). The variants built: #7 (0, 0, 0), #8 (paged), #9 (paged,
// quant), #5 (paged, stair). One launch on `stream`; returns
// cudaGetLastError() after it, or cudaErrorInvalidValue for a shape or
// variant the body does not take.
int ff_tree_attention(const void* q, const void* k, const void* v,
                      const void* k_scale, const void* v_scale,
                      const void* tables, const void* lengths,
                      const void* allowed, void* out, void* part_acc,
                      void* part_ml, void* counters, int q_bf16, int paged, int quant,
                      int vec16, int stair, int b, int w, int h, int d, int max_len,
                      int span, int splits, int page_size, int num_pages,
                      long long tbl_sb, long long q_sb, long long q_sw, long long q_sh,
                      long long k_s0, long long k_s1, long long k_sh,
                      long long v_s0, long long v_s1, long long v_sh,
                      long long m_sb, long long m_sw,
                      float scale, void* stream) {
  if (w < 1 || w > 8 * kTy || d < 4 || d > 256 || d % 4 || (quant && (d % 8 || (vec16 && d % 16))) ||
      splits < 1 || splits > kMaxSplits || span < 1 || span % kSpanUnit ||
      (long long)span * splits < max_len || (!stair && allowed == nullptr) ||
      (quant && (k_scale == nullptr || v_scale == nullptr)) ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  // the mask rows may be read as 4-byte words where they are so aligned
  const int mask_vec4 = (uintptr_t)allowed % 4 == 0 && m_sb % 4 == 0 && m_sw % 4 == 0;
  Params p{q, k, v, (const float*)k_scale, (const float*)v_scale,
           (const int*)lengths, (const int*)tables, (const uint8_t*)allowed,
           out, (float*)part_acc, (float*)part_ml, (unsigned int*)counters,
           w, h, d, max_len, span, splits, paged ? page_size : 1, num_pages,
           mask_vec4, vec16, tbl_sb, q_sb, q_sw, q_sh, k_s0, k_s1, k_sh,
           v_s0, v_s1, v_sh, m_sb, m_sw, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const int variant = (paged ? 4 : 0) | (quant ? 2 : 0) | (stair ? 1 : 0);
  return q_bf16 ? launch_variant<__nv_bfloat16>(variant, p, b, s) : launch_variant<float>(variant, p, b, s);
}

}  // extern "C"
