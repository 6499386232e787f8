// Flash-decode / verify attention against the serving KV cache, for Hopper
// (sm_90a), at head_dim > 256. Built by flexflow_tpu_torch/ops/cuda/_build.py
// with nvcc into a shared library with a plain C interface, loaded through
// ctypes by flexflow_tpu_torch/ops/cuda/decode_kernel.py.
//
// What it replaces: the six Pallas TPU kernels of
// flexflow_tpu/ops/pallas/decode_kernel.py past the register tiles of
// tree_kernel.cu's split-KV body, which serves all six at head_dim <= 256.
// One device body templated on three compile-time flags, as the JAX family
// shares one body between decode (w == 1) and verify (w queries):
//   kPaged kQuant kTree
//     0      0      0    _decode_kernel :235 (flash_verify)              #4
//     1      0      0    _paged_kernel :342 (paged_flash_verify)         #5
//     1      1      0    _paged_kernel_quant :476                        #6
//     0      0      1    _tree_kernel :626 (flash_verify_tree)           #7
//     1      0      1    _paged_tree_kernel :732                         #8
//     1      1      1    _paged_tree_kernel_quant :849                   #9
// The wrapper picks the body by head_dim alone, before any launch; here
// any head_dim whose one-page chunk fits the shared memory (w = 64 at
// head_dim 320 does not, and the wrapper raises before a launch).
//   * kPaged: the cache is pools [num_pages, page, h, d] walked through the
//     block table; rows on a sentinel page (table entry outside
//     [0, num_pages)) are neither read nor counted.
//   * kQuant: the pools are int8 with one fp32 scale per (page, head); each
//     staged K/V element is turned to fp32 and multiplied by its page's
//     scale before the dot product, as the reference dequantizes
//     (decode_kernel.py:502/:508, attention._dequant_pages), so the staged
//     values are bit-identical to the dense dequant. A page with scale 0
//     (never written) reads as zeros.
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
// The design reads every visible K/V row once and nothing else:
//   * one thread block per (batch row, head), 256 threads;
//   * a loop inside the block over key chunks takes the place of the TPU's
//     sequential grid axis; positions past lengths[b] + w - 1 are never read
//     (the chunk gate p < lengths[b] + w of every variant);
//   * the cache is read in place through its strides, [b, max_len, h, d] and
//     [num_pages, page, h, d], with no transpose copy (the TPU kernel's
//     per-call [b, h, s, d] transpose was a layout artefact of its tiling);
//   * the paged layout resolves each row through the block table, so one
//     chunk spans several pages (the TPU walked one page per grid step, and
//     its int8 variants needed 32-row pages for the (32, 128) int8 tile;
//     here any page size that holds whole 16-byte loads works);
//   * each chunk is staged into shared memory with 16-byte loads issued by
//     every thread at once (4 fp32 or 16 int8 elements each), so many loads
//     are in flight per block; int8 rows are dequantized on the way in;
//   * online softmax (running max m, sum l, fp32 accumulator acc) in shared
//     memory; a masked entry contributes p = 0 explicitly (the TPU kernel
//     relied on chunk 0 being visited first), and the result is
//     acc / max(l, 1e-30), so a row that sees no allocated page yields 0.
// The chunk size is chosen from shared memory, not from the v5e-tuned
// 512-row default (_TUNED = {"block_k": 512}, decode_kernel.py:106): the
// wrapper takes the largest chunk whose staging buffers fit its budget
// (ff_decode_smem_bytes below); a paged chunk is a whole number of pages.
// It is the simple body, kept for heads no model of either package
// reaches: at 8 sequences x 16 heads its grid is 128 blocks on 132 SMs,
// each walking its chunks in series (tree_kernel.cu splits the positions
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

struct Params {
  const float* q;
  const void* k;         // float, or int8_t under kQuant
  const void* v;
  const float* k_scale;  // quant only: [num_pages, h] contiguous
  const float* v_scale;
  const int* lengths;
  const int* tables;         // paged only: [b, pages_per_seq] page ids
  const uint8_t* allowed;    // tree only: [b, w, max_len], last dim contiguous
  float* out;                // [b, w, h, d] contiguous
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

template <bool kPaged, bool kQuant, bool kTree>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ih = blockIdx.x;
  const int ib = blockIdx.y;
  const int w = p.w, d = p.d, bk = p.chunk, d4 = p.d / 4;
  // elements per 16-byte load of the cache
  constexpr int kVec = kQuant ? 16 : 4;
  const int dv = p.d / kVec;
  float* q_s = smem;           // [w][d]
  float* k_s = q_s + w * d;    // [bk][d]
  float* v_s = k_s + bk * d;   // [bk][d]
  float* acc = v_s + bk * d;   // [w][d]
  float* s_s = acc + w * d;    // [w][bk] scores, then probabilities
  float* m_s = s_s + w * bk;   // [w] running max
  float* l_s = m_s + w;        // [w] running sum of exp
  float* c_s = l_s + w;        // [w] this chunk's rescale factor
  int* ok_s = reinterpret_cast<int*>(c_s + w);  // [bk] row is on a real page
  uint8_t* vis_s = reinterpret_cast<uint8_t*>(ok_s + bk);  // tree: [w][bk]
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int length = p.lengths[ib];
  // positions [0, end) are visible to at least one query row
  const int end = min(length + w, p.max_len);

  const float* qb = p.q + ib * p.q_sb + ih * p.q_sh;
  for (int i = tid; i < w * d4; i += kThreads) {
    const int j = i / d4, c = i % d4;
    reinterpret_cast<float4*>(q_s)[i] =
        *reinterpret_cast<const float4*>(qb + j * p.q_sw + 4 * c);
  }
  for (int i = tid; i < w * d; i += kThreads) acc[i] = 0.f;
  for (int j = tid; j < w; j += kThreads) {
    m_s[j] = kMask;
    l_s[j] = 0.f;
  }
  __syncthreads();

  for (int k_start = 0; k_start < end; k_start += bk) {
    const int rows = min(bk, end - k_start);

#pragma unroll 4
    for (int i = tid; i < rows * dv; i += kThreads) {
      const int r = i / dv, c = i - r * dv;
      const int pos = k_start + r;
      bool ok = true;
      int page = 0;
      int64_t ko, vo;
      if (kPaged) {
        page = p.tables[ib * p.tbl_sb + pos / p.page_size];
        ok = page >= 0 && page < p.num_pages;
        const int64_t row = pos % p.page_size;
        ko = ok ? page * p.k_s0 + row * p.k_s1 : 0;
        vo = ok ? page * p.v_s0 + row * p.v_s1 : 0;
      } else {
        ko = ib * p.k_s0 + pos * p.k_s1;
        vo = ib * p.v_s0 + pos * p.v_s1;
      }
      ko += ih * p.k_sh + kVec * c;
      vo += ih * p.v_sh + kVec * c;
      if (kQuant) {
        int4 kr = make_int4(0, 0, 0, 0), vr = kr;
        float ks = 0.f, vs = 0.f;
        if (ok) {
          kr = *reinterpret_cast<const int4*>(
              reinterpret_cast<const int8_t*>(p.k) + ko);
          vr = *reinterpret_cast<const int4*>(
              reinterpret_cast<const int8_t*>(p.v) + vo);
          ks = p.k_scale[page * p.h + ih];
          vs = p.v_scale[page * p.h + ih];
        }
        store_dequant(k_s + r * d + kVec * c, kr, ks);
        store_dequant(v_s + r * d + kVec * c, vr, vs);
      } else {
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 vv = kv;
        if (ok) {
          kv = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(p.k) + ko);
          vv = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(p.v) + vo);
        }
        reinterpret_cast<float4*>(k_s)[i] = kv;
        reinterpret_cast<float4*>(v_s)[i] = vv;
      }
      if (c == 0) ok_s[r] = ok;
    }
    if (kTree) {
      // this chunk's mask rows; bytes along r are contiguous in memory
      const uint8_t* mb = p.allowed + ib * p.m_sb + k_start;
      for (int i = tid; i < w * rows; i += kThreads) {
        const int j = i / rows, r = i - j * rows;
        vis_s[j * bk + r] = mb[j * p.m_sw + r];
      }
    }
    __syncthreads();

    // scores: one warp per (query row, key row), lanes across head_dim
    for (int idx = warp; idx < w * rows; idx += kWarps) {
      const int j = idx / rows, r = idx - j * rows;
      float dot = 0.f;
      for (int c = lane; c < d; c += 32) dot += q_s[j * d + c] * k_s[r * d + c];
      dot = warp_sum(dot);
      if (lane == 0) {
        const bool seen = ok_s[r] && (kTree ? vis_s[j * bk + r] != 0
                                            : k_start + r <= length + j);
        s_s[j * bk + r] = seen ? dot * p.scale : kMask;
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int j = warp; j < w; j += kWarps) {
      float mx = kMask;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, s_s[j * bk + r]);
      mx = warp_max(mx);
      const float m_prev = m_s[j];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const bool seen = ok_s[r] && (kTree ? vis_s[j * bk + r] != 0
                                            : k_start + r <= length + j);
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
    __syncthreads();

    // acc = acc * corr + p @ V, threads across (query row, head_dim)
    for (int i = tid; i < w * d; i += kThreads) {
      const int j = i / d, c = i - j * d;
      float a = acc[i] * c_s[j];
      const float* pj = s_s + j * bk;
      for (int r = 0; r < rows; ++r) a += pj[r] * v_s[r * d + c];
      acc[i] = a;
    }
    __syncthreads();
  }

  float* ob = p.out + ((int64_t)ib * w * p.h + ih) * d;
  for (int i = tid; i < w * d; i += kThreads) {
    const int j = i / d, c = i - j * d;
    ob[(int64_t)j * p.h * d + c] = acc[i] / fmaxf(l_s[j], 1e-30f);
  }
}

size_t smem_bytes(int w, int d, int chunk, bool tree) {
  return sizeof(float) *
             (size_t)(2 * w * d + 2 * chunk * d + w * chunk + 3 * w) +
         sizeof(int) * (size_t)chunk + (tree ? (size_t)w * chunk : 0);
}

template <bool kPaged, bool kQuant, bool kTree>
int launch(const Params& p, int b, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<kPaged, kQuant, kTree>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const size_t smem = smem_bytes(p.w, p.d, p.chunk, kTree);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  dim3 grid(p.h, b);
  decode_attention_kernel<kPaged, kQuant, kTree>
      <<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block takes for (w, d, chunk) with or without
// the tree mask: the wrapper picks its chunk size against this, so the two
// can never disagree.
long long ff_decode_smem_bytes(int w, int d, int chunk, int tree) {
  return (long long)smem_bytes(w, d, chunk, tree != 0);
}

// The opt-in shared-memory ceiling the launches configure.
long long ff_decode_smem_limit(void) { return (long long)kMaxSmem; }

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One entry for the four variants. q [b, w, h, d] fp32 (head_dim
// contiguous); out [b, w, h, d] contiguous fp32; lengths [b] int32.
// Contiguous layout (paged == 0): k/v [b, max_len, h, d] fp32, strides
// (batch, position, head). Paged layout: k/v [num_pages, page_size, h, d]
// (fp32, or int8 with quant != 0 and k_scale/v_scale [num_pages, h]
// contiguous fp32), strides (page, row, head) in elements; tables
// [b, max_len / page_size] int32 whose entries outside [0, num_pages) are
// unallocated. tree != 0: allowed [b, w, max_len] uint8 with strides
// (m_sb, m_sw), nonzero = visible. chunk is a multiple of page_size on the
// paged layout. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a combination no variant serves (int8 on the
// contiguous layout).
int ff_decode_attention(const void* q, const void* k, const void* v,
                        const void* k_scale, const void* v_scale,
                        const void* tables, const void* lengths,
                        const void* allowed, void* out, int paged, int quant,
                        int tree, int b, int w, int h, int d, int max_len,
                        int chunk, int page_size, int num_pages,
                        long long tbl_sb, long long q_sb, long long q_sw,
                        long long q_sh, long long k_s0, long long k_s1,
                        long long k_sh, long long v_s0, long long v_s1,
                        long long v_sh, long long m_sb, long long m_sw,
                        float scale, void* stream) {
  Params p{(const float*)q, k, v,
           (const float*)k_scale, (const float*)v_scale,
           (const int*)lengths, (const int*)tables, (const uint8_t*)allowed,
           (float*)out,
           w, h, d, chunk, max_len, paged ? page_size : 1, num_pages,
           tbl_sb, q_sb, q_sw, q_sh, k_s0, k_s1, k_sh, v_s0, v_s1, v_sh,
           m_sb, m_sw, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const int variant = (paged ? 4 : 0) | (quant ? 2 : 0) | (tree ? 1 : 0);
  switch (variant) {
    case 0: return launch<false, false, false>(p, b, s);  // #4
    case 1: return launch<false, false, true>(p, b, s);   // #7
    case 4: return launch<true, false, false>(p, b, s);   // #5
    case 5: return launch<true, false, true>(p, b, s);    // #8
    case 6: return launch<true, true, false>(p, b, s);    // #6
    case 7: return launch<true, true, true>(p, b, s);     // #9
    default: return (int)cudaErrorInvalidValue;  // int8 needs the paged layout
  }
}

}  // extern "C"
