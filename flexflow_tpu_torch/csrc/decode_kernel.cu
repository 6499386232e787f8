// Flash-decode / verify attention against the serving KV cache, for Hopper
// (sm_90a), at head_dim > 256. Built by flexflow_tpu_torch/ops/cuda/_build.py
// with nvcc into a shared library with a plain C interface, loaded through
// ctypes by flexflow_tpu_torch/ops/cuda/decode_kernel.py.
//
// What it replaces: the six Pallas TPU kernels of
// flexflow_tpu/ops/pallas/decode_kernel.py past the register tiles of
// tree_kernel.cu's split-KV body, which serves all six at head_dim <= 256.
// One device body templated on q's element type and three compile-time
// flags, as the JAX family shares one body between decode (w == 1) and
// verify (w queries):
//   kPaged kQuant kTree
//     0      0      0    _decode_kernel :235 (flash_verify)              #4
//     1      0      0    _paged_kernel :342 (paged_flash_verify)         #5
//     1      1      0    _paged_kernel_quant :476                        #6
//     0      0      1    _tree_kernel :626 (flash_verify_tree)           #7
//     1      0      1    _paged_tree_kernel :732                         #8
//     1      1      1    _paged_tree_kernel_quant :849                   #9
// The wrapper picks the body by head_dim alone, before any launch; this
// body takes any w <= 64 at any head_dim that is a multiple of 4 (of 8 on
// int8 pools), w = 64 at head_dim 320 included: shared memory does not
// grow with head_dim.
//   * q and the output are float, or __nv_bfloat16 (a mixed-precision
//     model's projections; the pools stay fp32 or int8): bf16 q is widened
//     to fp32 as it is staged, the scores, the softmax and the accumulator
//     stay fp32 (the reference's dots take preferred_element_type f32 and
//     cast P to the V pool's dtype, :218), and the output is rounded to
//     bf16 as it is written, the reference's .astype(o_ref.dtype) (:229).
//   * kPaged: the cache is pools [num_pages, page, h, d] walked through the
//     block table; rows on a sentinel page (table entry outside
//     [0, num_pages)) are neither read nor counted.
//   * kQuant: the pools are int8 with one fp32 scale per (page, head); each
//     staged K/V element is turned to fp32 and multiplied by its page's
//     scale before the dot product, as the reference dequantizes
//     (decode_kernel.py:502/:508, attention._dequant_pages), so the staged
//     values are bit-identical to the dense dequant. A page with scale 0
//     (never written) reads as zeros. Rows are read in 8-byte loads.
//   * kTree: query row j sees position p iff allowed[b, j, p] != 0 (a uint8
//     mask over logical positions, built from the draft tree's parent table
//     by ops/attention.tree_allowed_mask), in place of the staircase
//     p <= lengths[b] + j. The paged variants index it by the logical
//     position, so it needs no table lookup.
//
// What bounds it: the bytes of the K/V rows some query can see (plus the
// mask rows of a tree verify). A decode step does 4 * w * rows * d flops
// for 8 * rows * d bytes read (2 * rows * d as int8), far below the card's
// operations-per-byte balance, so the kernel is bound by device memory.
// The design keeps every buffer at a fixed width of head_dim:
//   * one thread block per (output piece, head, batch row), 256 threads;
//     an output piece is kPiece = 64 columns of head_dim, so a head of 320
//     columns takes 5 blocks, each writing its own columns;
//   * a loop inside the block over key chunks takes the place of the TPU's
//     sequential grid axis; positions past lengths[b] + w - 1 are never read
//     (the chunk gate p < lengths[b] + w of every variant); each row's cache
//     offset (and page scale) is resolved once per chunk;
//   * the scores of a chunk are contracted over head_dim in kPiece-column
//     pieces: one piece of q (w rows) and of K (the chunk's rows) staged
//     at a time, each (query, key) pair's dot product added into its score;
//     then the online softmax, then the block's own piece of V staged into
//     the key piece's buffer for acc += P V. Every block of a (head, row)
//     recomputes the same scores: K is read once per output piece (from L2
//     after the first), where a full-width staging would grow with head_dim
//     (it held no 320-wide chunk at w = 64);
//   * the cache is read in place through its strides, [b, max_len, h, d] and
//     [num_pages, page, h, d], with no transpose copy (the TPU kernel's
//     per-call [b, h, s, d] transpose was a layout artefact of its tiling);
//   * the paged layout resolves each row through the block table, so one
//     chunk spans several pages and need not be a whole number of them (the
//     TPU walked one page per grid step, and its int8 variants needed
//     32-row pages for the (32, 128) int8 tile);
//   * online softmax (running max m, sum l, fp32 accumulator acc) in shared
//     memory; a masked entry contributes p = 0 explicitly (the TPU kernel
//     relied on chunk 0 being visited first), and the result is
//     acc / max(l, 1e-30), so a row that sees no allocated page yields 0.
// The chunk size is chosen from shared memory, not from the v5e-tuned
// 512-row default (_TUNED = {"block_k": 512}, decode_kernel.py:106): the
// wrapper takes the largest chunk whose buffers fit its budget
// (ff_decode_smem_bytes below). It is the simple body, kept for heads no
// model of either package reaches (tree_kernel.cu splits the positions
// across blocks instead).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMask = -1e30f;
// the opt-in shared-memory ceiling of one block on sm_90
constexpr int kMaxSmem = 232448;
// columns of head_dim staged at a time, and of the output one block owns
constexpr int kPiece = 64;
// row stride of a staged piece: 4 floats of padding against bank conflicts
constexpr int kLd = kPiece + 4;

struct Params {
  const void* q;         // float or __nv_bfloat16
  const void* k;         // float, or int8_t under kQuant
  const void* v;
  const float* k_scale;  // quant only: [num_pages, h] contiguous
  const float* v_scale;
  const int* lengths;
  const int* tables;         // paged only: [b, pages_per_seq] page ids
  const uint8_t* allowed;    // tree only: [b, w, max_len], last dim contiguous
  void* out;                 // [b, w, h, d] contiguous, q's element type
  int w, h, d;
  int chunk;      // rows staged per loop iteration
  int max_len;    // positions a sequence can hold
  int page_size;  // paged only
  int num_pages;  // paged only: entries outside [0, num_pages) are sentinels
  int64_t tbl_sb;
  int64_t q_sb, q_sw, q_sh;
  // contiguous: (batch, position, head) strides; paged: (page, row, head);
  // in elements of the cache's type
  int64_t k_s0, k_s1, k_sh;
  int64_t v_s0, v_s1, v_sh;
  int64_t m_sb, m_sw;  // tree only: mask (batch, query row) strides
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Columns [c1, c1 + pw) of the chunk's first `rows` K or V rows into dst
// [rows][kLd]: fp32 in 16-byte loads, int8 in 8-byte loads times the row's
// page scale; a row whose offset is -1 (past the range or on a sentinel
// page) stages zeros.
template <bool kQuant>
__device__ __forceinline__ void stage_rows(float* dst, const void* src, const int64_t* off,
                                           const float* sc, int c1, int pw, int rows) {
  if (kQuant) {
    const int n8 = pw / 8;
    for (int i = threadIdx.x; i < rows * n8; i += kThreads) {
      const int r = i / n8, c = i - r * n8;
      int2 raw = make_int2(0, 0);
      if (off[r] >= 0) raw = __ldg(reinterpret_cast<const int2*>(static_cast<const int8_t*>(src) + off[r] + c1) + c);
      store_dequant8(dst + r * kLd + 8 * c, raw, sc[r]);
    }
  } else {
    const int n4 = pw / 4;
    for (int i = threadIdx.x; i < rows * n4; i += kThreads) {
      const int r = i / n4, c = i - r * n4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (off[r] >= 0) x = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(src) + off[r] + c1) + c);
      reinterpret_cast<float4*>(dst + r * kLd)[c] = x;
    }
  }
}

template <typename TQ, bool kPaged, bool kQuant, bool kTree>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int w = p.w, d = p.d, bk = p.chunk;
  int64_t* ko_s = reinterpret_cast<int64_t*>(smem4);  // [bk] K row offsets (head included), -1 = not read
  int64_t* vo_s = ko_s + bk;                           // [bk] V row offsets
  float* q_s = reinterpret_cast<float*>(vo_s + bk);    // [w][kLd] a piece of q
  float* kv_s = q_s + w * kLd;                         // [bk][kLd] a piece of K, then the block's V
  float* acc = kv_s + bk * kLd;                        // [w][kPiece] the block's output columns
  float* s_s = acc + w * kPiece;                       // [w][bk] scores, then probabilities
  float* m_s = s_s + w * bk;                           // [w] running max
  float* l_s = m_s + w;                                // [w] running sum of exp
  float* c_s = l_s + w;                                // [w] this chunk's rescale factor
  float* ks_s = c_s + w;                               // quant: [bk] page scales
  float* vs_s = ks_s + bk;
  uint8_t* vis_s = reinterpret_cast<uint8_t*>(vs_s + bk);  // tree: [w][bk]
  const int c0 = blockIdx.x * kPiece, cw = min(kPiece, d - c0);  // this block's output columns
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int length = p.lengths[ib];
  // positions [0, end) are visible to at least one query row
  const int end = min(length + w, p.max_len);
  const TQ* qb = static_cast<const TQ*>(p.q) + ib * p.q_sb + ih * p.q_sh;

  for (int i = tid; i < w * kPiece; i += kThreads) acc[i] = 0.f;
  for (int j = tid; j < w; j += kThreads) {
    m_s[j] = kMask;
    l_s[j] = 0.f;
  }

  for (int k_start = 0; k_start < end; k_start += bk) {
    const int rows = min(bk, end - k_start);
    // where each row of the chunk lives, and its page's scales
    for (int r = tid; r < rows; r += kThreads) {
      const int pos = k_start + r;
      int64_t ko = -1, vo = -1;
      float ks = 0.f, vs = 0.f;
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
      ko_s[r] = ko;
      vo_s[r] = vo;
      if (kQuant) {
        ks_s[r] = ks;
        vs_s[r] = vs;
      }
    }
    if (kTree) {
      // this chunk's mask rows; bytes along r are contiguous in memory
      const uint8_t* mb = p.allowed + ib * p.m_sb + k_start;
      for (int i = tid; i < w * rows; i += kThreads) {
        const int j = i / rows, r = i - j * rows;
        vis_s[j * bk + r] = mb[j * p.m_sw + r];
      }
    }
    for (int i = tid; i < w * rows; i += kThreads) {
      const int j = i / rows, r = i - j * rows;
      s_s[j * bk + r] = 0.f;
    }

    // scores over head_dim, one kPiece-wide piece of q and K at a time;
    // thread i owns the (query row, key row) pairs i, i + kThreads, ...
    for (int c1 = 0; c1 < d; c1 += kPiece) {
      const int pw = min(kPiece, d - c1), p4 = pw / 4;
      __syncthreads();  // the offsets are in; every thread is done with the buffers
      for (int i = tid; i < w * p4; i += kThreads) {
        const int j = i / p4, c = i - j * p4;
        reinterpret_cast<float4*>(q_s + j * kLd)[c] = load4<TQ>(qb + j * p.q_sw + c1 + 4 * c);
      }
      stage_rows<kQuant>(kv_s, p.k, ko_s, ks_s, c1, pw, rows);
      __syncthreads();  // the pieces are in
      for (int i = tid; i < w * rows; i += kThreads) {
        const int j = i / rows, r = i - j * rows;
        const float4* qq = reinterpret_cast<const float4*>(q_s + j * kLd);
        const float4* kk = reinterpret_cast<const float4*>(kv_s + r * kLd);
        float dot = 0.f;
        for (int c = 0; c < p4; ++c) {
          const float4 a = qq[c], b = kk[c];
          dot += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
        }
        s_s[j * bk + r] += dot;
      }
    }
    __syncthreads();

    // mask, scale and online softmax: one warp per query row
    for (int j = warp; j < w; j += kWarps) {
      float mx = kMask;
      for (int r = lane; r < rows; r += 32) {
        const bool seen = ko_s[r] >= 0 && (kTree ? vis_s[j * bk + r] != 0 : k_start + r <= length + j);
        const float sv = seen ? s_s[j * bk + r] * p.scale : kMask;
        s_s[j * bk + r] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[j];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const bool seen = ko_s[r] >= 0 && (kTree ? vis_s[j * bk + r] != 0 : k_start + r <= length + j);
        const float pr = seen ? expf(s_s[j * bk + r] - m_new) : 0.f;
        s_s[j * bk + r] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[j] = corr;
        l_s[j] = l_s[j] * corr + sum;
        m_s[j] = m_new;
      }
    }
    // the block's columns of V into the key piece's buffer
    stage_rows<kQuant>(kv_s, p.v, vo_s, vs_s, c0, cw, rows);
    __syncthreads();

    // acc = acc * corr + p @ V, threads across (query row, column)
    for (int i = tid; i < w * cw; i += kThreads) {
      const int j = i / cw, c = i - j * cw;
      float a = acc[j * kPiece + c] * c_s[j];
      const float* pj = s_s + j * bk;
      for (int r = 0; r < rows; ++r) a += pj[r] * kv_s[r * kLd + c];
      acc[j * kPiece + c] = a;
    }
    __syncthreads();
  }

  __syncthreads();  // (m, l) and acc are set, also where no chunk ran
  TQ* ob = static_cast<TQ*>(p.out) + ((int64_t)ib * w * p.h + ih) * d + c0;
  for (int i = tid; i < w * cw; i += kThreads) {
    const int j = i / cw, c = i - j * cw;
    ob[(int64_t)j * p.h * d + c] = from_f32<TQ>(acc[j * kPiece + c] / fmaxf(l_s[j], 1e-30f));
  }
}

// the row offsets, the q piece, the K/V piece, the accumulator, the
// scores, (m, l, corr), the page scales and the tree mask: no term grows
// with head_dim
size_t smem_bytes(int w, int chunk, bool tree) {
  return 2 * sizeof(int64_t) * (size_t)chunk +
         sizeof(float) * (size_t)(w * kLd + chunk * kLd + w * kPiece + w * chunk + 3 * w + 2 * chunk) +
         (tree ? (size_t)w * chunk : 0);
}

template <typename TQ, bool kPaged, bool kQuant, bool kTree>
int launch(const Params& p, int b, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<TQ, kPaged, kQuant, kTree>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const size_t smem = smem_bytes(p.w, p.chunk, kTree);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  dim3 grid((p.d + kPiece - 1) / kPiece, p.h, b);
  decode_attention_kernel<TQ, kPaged, kQuant, kTree>
      <<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_variant(int variant, const Params& p, int b, cudaStream_t s) {
  switch (variant) {
    case 0: return launch<TQ, false, false, false>(p, b, s);  // #4
    case 1: return launch<TQ, false, false, true>(p, b, s);   // #7
    case 4: return launch<TQ, true, false, false>(p, b, s);   // #5
    case 5: return launch<TQ, true, false, true>(p, b, s);    // #8
    case 6: return launch<TQ, true, true, false>(p, b, s);    // #6
    case 7: return launch<TQ, true, true, true>(p, b, s);     // #9
    default: return (int)cudaErrorInvalidValue;  // int8 needs the paged layout
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block takes for (w, chunk) with or without the
// tree mask, whatever head_dim is: the wrapper picks its chunk size against
// this, so the two can never disagree.
long long ff_decode_smem_bytes(int w, int chunk, int tree) {
  return (long long)smem_bytes(w, chunk, tree != 0);
}

// The opt-in shared-memory ceiling the launches configure.
long long ff_decode_smem_limit(void) { return (long long)kMaxSmem; }

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One entry for the six variants. q [b, w, h, d] fp32, or bf16 with
// q_bf16 != 0 (head_dim contiguous, rows 4-element aligned); out
// [b, w, h, d] contiguous in q's type; lengths [b] int32. head_dim a
// multiple of 4 (of 8 on int8 pools). Contiguous layout (paged == 0): k/v
// [b, max_len, h, d] fp32, strides (batch, position, head). Paged layout:
// k/v [num_pages, page_size, h, d] (fp32, or int8 with quant != 0, rows
// 8-byte aligned, and k_scale/v_scale [num_pages, h] contiguous fp32),
// strides (page, row, head) in elements; tables [b, max_len / page_size]
// int32 whose entries outside [0, num_pages) are unallocated. tree != 0:
// allowed [b, w, max_len] uint8 with strides (m_sb, m_sw), nonzero =
// visible. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a combination no variant serves (int8 on the
// contiguous layout).
int ff_decode_attention(const void* q, const void* k, const void* v,
                        const void* k_scale, const void* v_scale,
                        const void* tables, const void* lengths,
                        const void* allowed, void* out, int q_bf16, int paged,
                        int quant, int tree, int b, int w, int h, int d,
                        int max_len, int chunk, int page_size, int num_pages,
                        long long tbl_sb, long long q_sb, long long q_sw,
                        long long q_sh, long long k_s0, long long k_s1,
                        long long k_sh, long long v_s0, long long v_s1,
                        long long v_sh, long long m_sb, long long m_sw,
                        float scale, void* stream) {
  if (d < 4 || d % 4 || (quant && d % 8) || w < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  Params p{q, k, v,
           (const float*)k_scale, (const float*)v_scale,
           (const int*)lengths, (const int*)tables, (const uint8_t*)allowed,
           out,
           w, h, d, chunk, max_len, paged ? page_size : 1, num_pages,
           tbl_sb, q_sb, q_sw, q_sh, k_s0, k_s1, k_sh, v_s0, v_s1, v_sh,
           m_sb, m_sw, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const int variant = (paged ? 4 : 0) | (quant ? 2 : 0) | (tree ? 1 : 0);
  return q_bf16 ? launch_variant<__nv_bfloat16>(variant, p, b, s) : launch_variant<float>(variant, p, b, s);
}

}  // extern "C"
