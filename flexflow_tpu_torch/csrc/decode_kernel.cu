// Flash-decode / verify attention against the serving KV cache, for Hopper
// (sm_90a). Built by flexflow_tpu_torch/ops/cuda/_build.py with nvcc into a
// shared library with a plain C interface, loaded through ctypes by
// flexflow_tpu_torch/ops/cuda/decode_kernel.py.
//
// What it replaces: the Pallas TPU kernels _decode_kernel
// (flexflow_tpu/ops/pallas/decode_kernel.py:235, entry flash_verify) and
// _paged_kernel (same file :342, entry paged_flash_verify). One device body,
// templated on the cache layout, serves both, as the JAX family shares one
// body between decode (w == 1) and verify (w queries under the staircase mask
// key_pos <= lengths[b] + j).
//
// What bounds it: the bytes of the K/V rows some query can see. A decode step
// does 4 * w * rows * d flops for 8 * rows * d bytes read, far below the
// card's operations-per-byte balance, so the kernel is bound by device memory.
// The design reads every visible K/V row once and nothing else:
//   * one thread block per (batch row, head), 256 threads;
//   * a loop inside the block over key chunks takes the place of the TPU's
//     sequential grid axis; positions past lengths[b] + w - 1 are never read;
//   * the cache is read in place through its strides, [b, max_len, h, d] and
//     [num_pages, page, h, d], with no transpose copy (the TPU kernel's
//     per-call [b, h, s, d] transpose was a layout artefact of its tiling);
//   * the paged layout resolves each row through the block table, so one
//     chunk spans several pages; rows on a sentinel page (table entry outside
//     [0, num_pages)) are neither read nor counted;
//   * each chunk is staged into shared memory with 16-byte loads issued by
//     every thread at once, so many loads are in flight per block;
//   * online softmax (running max m, sum l, fp32 accumulator acc) in shared
//     memory; a masked entry contributes p = 0 explicitly (the TPU kernel
//     relied on chunk 0 being visited first), and the result is
//     acc / max(l, 1e-30), so a row that sees no allocated page yields 0.
// The chunk size is chosen from shared memory, not from the v5e-tuned
// 512-row default (_TUNED = {"block_k": 512}, decode_kernel.py:106): the
// wrapper takes the largest chunk whose staging buffers fit its budget
// (ff_decode_smem_bytes below); a paged chunk is a whole number of pages.
// Split-KV across blocks, cp.async/TMA pipelining and tensor cores are left
// to later work: at 8 sequences x 16 heads this grid is 128 blocks on 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMask = -1e30f;
// the opt-in shared-memory ceiling of one block on sm_90
constexpr int kMaxSmem = 232448;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* lengths;
  const int* tables;  // paged only: [b, pages_per_seq] page ids
  float* out;         // [b, w, h, d] contiguous
  int w, h, d;
  int chunk;      // rows staged per loop iteration
  int max_len;    // positions a sequence can hold
  int page_size;  // paged only
  int num_pages;  // paged only: entries outside [0, num_pages) are sentinels
  int64_t tbl_sb;
  int64_t q_sb, q_sw, q_sh;
  // contiguous: (batch, position, head) strides; paged: (page, row, head)
  int64_t k_s0, k_s1, k_sh;
  int64_t v_s0, v_s1, v_sh;
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

template <bool kPaged>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ih = blockIdx.x;
  const int ib = blockIdx.y;
  const int w = p.w, d = p.d, bk = p.chunk, d4 = p.d / 4;
  float* q_s = smem;           // [w][d]
  float* k_s = q_s + w * d;    // [bk][d]
  float* v_s = k_s + bk * d;   // [bk][d]
  float* acc = v_s + bk * d;   // [w][d]
  float* s_s = acc + w * d;    // [w][bk] scores, then probabilities
  float* m_s = s_s + w * bk;   // [w] running max
  float* l_s = m_s + w;        // [w] running sum of exp
  float* c_s = l_s + w;        // [w] this chunk's rescale factor
  int* ok_s = reinterpret_cast<int*>(c_s + w);  // [bk] row is on a real page
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
    for (int i = tid; i < rows * d4; i += kThreads) {
      const int r = i / d4, c = i - r * d4;
      const int pos = k_start + r;
      bool ok = true;
      int64_t ko, vo;
      if (kPaged) {
        const int page = p.tables[ib * p.tbl_sb + pos / p.page_size];
        ok = page >= 0 && page < p.num_pages;
        const int64_t row = pos % p.page_size;
        ko = ok ? page * p.k_s0 + row * p.k_s1 : 0;
        vo = ok ? page * p.v_s0 + row * p.v_s1 : 0;
      } else {
        ko = ib * p.k_s0 + pos * p.k_s1;
        vo = ib * p.v_s0 + pos * p.v_s1;
      }
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (ok) {
        kv = *reinterpret_cast<const float4*>(p.k + ko + ih * p.k_sh + 4 * c);
        vv = *reinterpret_cast<const float4*>(p.v + vo + ih * p.v_sh + 4 * c);
      }
      reinterpret_cast<float4*>(k_s)[i] = kv;
      reinterpret_cast<float4*>(v_s)[i] = vv;
      if (c == 0) ok_s[r] = ok;
    }
    __syncthreads();

    // scores: one warp per (query row, key row), lanes across head_dim
    for (int idx = warp; idx < w * rows; idx += kWarps) {
      const int j = idx / rows, r = idx - j * rows;
      float dot = 0.f;
      for (int c = lane; c < d; c += 32) dot += q_s[j * d + c] * k_s[r * d + c];
      dot = warp_sum(dot);
      if (lane == 0) {
        const bool seen = ok_s[r] && k_start + r <= length + j;
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
        const bool seen = ok_s[r] && k_start + r <= length + j;
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

size_t smem_bytes(int w, int d, int chunk) {
  return sizeof(float) *
             (size_t)(2 * w * d + 2 * chunk * d + w * chunk + 3 * w) +
         sizeof(int) * (size_t)chunk;
}

template <bool kPaged>
int launch(const Params& p, int b, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<kPaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const size_t smem = smem_bytes(p.w, p.d, p.chunk);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  dim3 grid(p.h, b);
  decode_attention_kernel<kPaged><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block takes for (w, d, chunk): the wrapper picks
// its chunk size against this, so the two can never disagree.
long long ff_decode_smem_bytes(int w, int d, int chunk) {
  return (long long)smem_bytes(w, d, chunk);
}

// The opt-in shared-memory ceiling the launches configure.
long long ff_decode_smem_limit(void) { return (long long)kMaxSmem; }

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q [b, w, h, d]; k/v [b, max_len, h, d] (head_dim contiguous); lengths [b]
// int32; out [b, w, h, d] contiguous fp32. Returns cudaGetLastError().
int ff_flash_verify_f32(const void* q, const void* k, const void* v,
                        const void* lengths, void* out, int b, int w, int h,
                        int d, int max_len, int chunk, long long q_sb,
                        long long q_sw, long long q_sh, long long k_sb,
                        long long k_ss, long long k_sh, long long v_sb,
                        long long v_ss, long long v_sh, float scale,
                        void* stream) {
  Params p{(const float*)q, (const float*)k, (const float*)v,
           (const int*)lengths, nullptr, (float*)out,
           w, h, d, chunk, max_len, 1, 0, 0,
           q_sb, q_sw, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale};
  return launch<false>(p, b, (cudaStream_t)stream);
}

// k_pool/v_pool [num_pages, page_size, h, d]; tables [b, pages_per_seq]
// int32 (entries outside [0, num_pages) are unallocated); chunk a multiple
// of page_size. The rest as above.
int ff_paged_flash_verify_f32(const void* q, const void* k_pool,
                              const void* v_pool, const void* tables,
                              const void* lengths, void* out, int b, int w,
                              int h, int d, int num_pages, int page_size,
                              int pages_per_seq, int chunk, long long tbl_sb,
                              long long q_sb, long long q_sw, long long q_sh,
                              long long k_sp, long long k_sr, long long k_sh,
                              long long v_sp, long long v_sr, long long v_sh,
                              float scale, void* stream) {
  Params p{(const float*)q, (const float*)k_pool, (const float*)v_pool,
           (const int*)lengths, (const int*)tables, (float*)out,
           w, h, d, chunk, pages_per_seq * page_size, page_size, num_pages,
           tbl_sb, q_sb, q_sw, q_sh, k_sp, k_sr, k_sh, v_sp, v_sr, v_sh,
           scale};
  return launch<true>(p, b, (cudaStream_t)stream);
}

}  // extern "C"
