// Flash attention forward for Hopper (sm_90a), fp32. Built by
// flexflow_tpu_torch/ops/cuda/_build.py with nvcc into a shared library with
// a plain C interface, loaded through ctypes by
// flexflow_tpu_torch/ops/cuda/flash_kernel.py. The backward (#2, #3) is
// csrc/flash_bwd_kernel.cu.
//
// What it replaces: flash_fwd_kernel replaces the Pallas TPU kernel
// _fwd_kernel of flexflow_tpu/ops/pallas/flash_kernel.py (:129, pallas_call
// in _fwd :198): O = softmax(Q K^T * scale) V with the row log-sum-exp LSE.
//
// What bounds it: operations. Each (64 x 64) tile pair costs 2 products of
// depth head_dim, against 16-32 KB of operands that every block of a
// (batch, head) shares through L2; at the flagship shape (b 8, s 512, h 16,
// d 64) one forward is 8.6 GFLOP for 67 MB of q, k, v and o, far past the
// card's fp32 balance (67 TFLOP/s over 3.35 TB/s = 20 flops a byte). The
// design keeps the [s, s] scores out of device memory and does the products
// with fp32 FMAs (the model is fp32 end to end and TF32 stays off):
//   * one block of 256 threads per (64-row tile, batch * head); a loop inside
//     the block over the key tiles takes the place of the TPU's sequential
//     grid axis;
//   * tiles are staged in shared memory, transposed ([d][64]) where a product
//     reads them along head_dim, so each thread reads 16-byte vectors and
//     does a 4 x 4 (scores) or 4 x 4*kG (outputs) register tile of FMAs;
//   * the softmax state (m, l) and the output accumulators live in registers;
//     a row's 64 scores sit in 16 neighbouring lanes and are reduced with
//     shuffles;
//   * masked and padded entries weigh exactly 0: p is set to 0 for them
//     whatever the running max is, and rows past the end of a ragged tile
//     are zero-filled and never stored;
//   * the causal mask is qpos >= kpos from a shared origin (also when
//     sq != sk); the loop stops at the diagonal key tile;
//   * [b, s, h, d] operands are read in place through their strides: no
//     transpose to [b, h, s, d] (a layout artefact of the TPU tiling), and
//     LSE is [b, h, s] rows, not the TPU's 128-lane broadcasts.
// The v5e tiles (_TUNED = {"block_q": 512, "block_k": 1024}, set_tuned_blocks,
// the calibration table's flash_blocks) do not carry over: 64 x 64 tiles are
// what 227 KB of shared memory and the register file take here, and the
// ragged tail is masked, so any sequence length works. Tensor cores (the
// backward's 3xTF32 mma helpers), TMA and pipelined stages are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 score tile each
constexpr int kPS = kTile + 4;  // row stride of a score tile (16-byte aligned)
constexpr float kMask = -1e30f;
constexpr int kMaxSmem = 232448;  // opt-in shared memory of one block, sm_90

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out0;         // O (contiguous [b, sq, h, d])
  float* out1;         // LSE [b, h, sq]
  int h, sq, sk, d;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  float scale;
  int causal;
};

// Rows [row0, row0 + 64) of one head of a [b, s, h, d] tensor (base already
// at the batch and head) into shared memory: row-major [64][ld] and/or
// transposed [d][64]. Rows at or past `rows` are zero. Consecutive threads
// take consecutive rows, so the transposed stores hit distinct banks, and
// ld = d + 4 does the same for the row-major ones.
template <bool kRowMajor, bool kTransposed>
__device__ __forceinline__ void load_tile(const float* base, int64_t s_stride,
                                          int row0, int rows, int d,
                                          float* rm, int ld, float* tr) {
  const int d4 = d / 4;
  for (int i = threadIdx.x; i < kTile * d4; i += kThreads) {
    const int r = i % kTile, c4 = i / kTile;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows)
      x = *reinterpret_cast<const float4*>(base + (int64_t)(row0 + r) * s_stride + 4 * c4);
    if (kRowMajor) *reinterpret_cast<float4*>(rm + r * ld + 4 * c4) = x;
    if (kTransposed) {
      tr[(4 * c4 + 0) * kTile + r] = x.x;
      tr[(4 * c4 + 1) * kTile + r] = x.y;
      tr[(4 * c4 + 2) * kTile + r] = x.z;
      tr[(4 * c4 + 3) * kTile + r] = x.w;
    }
  }
}

// s[i][j] = sum_c At[c][ty*4 + i] * Bt[c][tx*4 + j] over c < d: a 4 x 4 tile
// of a (64 x 64) product of two transposed [d][64] tiles.
__device__ __forceinline__ void tile_product(const float* At, const float* Bt,
                                             int d, int ty, int tx,
                                             float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(At + c * kTile + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(Bt + c * kTile + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][g][:] += sum_r A(row ty*4 + i, r) * B[r][4*(tx + 16 g) : +4] over
// the 64 rows r of a score tile A stored row-major [64][kPS].
template <int kG>
__device__ __forceinline__ void accumulate(const float* S, const float* B,
                                           int ld, int d4, int ty, int tx,
                                           float acc[4][kG][4]) {
#pragma unroll 2
  for (int r = 0; r < kTile; ++r) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = S[(ty * 4 + i) * kPS + r];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (tx + 16 * g < d4) {
        const float4 b = *reinterpret_cast<const float4*>(B + r * ld + 4 * (tx + 16 * g));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g][0] = fmaf(a[i], b.x, acc[i][g][0]);
          acc[i][g][1] = fmaf(a[i], b.y, acc[i][g][1]);
          acc[i][g][2] = fmaf(a[i], b.z, acc[i][g][2]);
          acc[i][g][3] = fmaf(a[i], b.w, acc[i][g][3]);
        }
      }
    }
  }
}

template <int kG>
__device__ __forceinline__ void zero_acc(float acc[4][kG][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][g][t] = 0.f;
}

// Rows ty*4 + i of a tile starting at row0 of a contiguous [b, s, h, d]
// output, each divided by div[i], rows at or past `rows` skipped.
template <int kG>
__device__ __forceinline__ void store_rows(float* out, int ib, int ih, int h,
                                           int s, int row0, int d, int ty,
                                           int tx, const float acc[4][kG][4],
                                           const float div[4]) {
  const int d4 = d / 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= s) continue;
    float* o = out + (((int64_t)ib * s + row) * h + ih) * d;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int c4 = tx + 16 * g;
      if (c4 < d4)
        *reinterpret_cast<float4*>(o + 4 * c4) =
            make_float4(acc[i][g][0] / div[i], acc[i][g][1] / div[i],
                        acc[i][g][2] / div[i], acc[i][g][3] / div[i]);
    }
  }
}

// Reductions over the 16 lanes holding one score row (lanes of one half warp).
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  return qi < p.sq && kj < p.sk && (!p.causal || qi >= kj);
}

__device__ __forceinline__ void store_tile(float* S, int ty, int tx,
                                           const float v[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(S + (ty * 4 + i) * kPS + tx * 4) =
        make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
}

// -- forward ------------------------------------------------------------------

template <int kG>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int d = p.d, d4 = d / 4, ld = d + 4;
  float* qt = reinterpret_cast<float*>(smem4);  // [d][64]
  float* kt = qt + d * kTile;                    // [d][64]
  float* vs = kt + d * kTile;                    // [64][ld]
  float* ps = vs + kTile * ld;                   // [64][kPS]
  const int q0 = blockIdx.x * kTile, ib = blockIdx.y / p.h, ih = blockIdx.y % p.h;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kb = p.k + ib * p.k_sb + ih * p.k_sh;
  const float* vb = p.v + ib * p.v_sb + ih * p.v_sh;
  load_tile<false, true>(p.q + ib * p.q_sb + ih * p.q_sh, p.q_ss, q0, p.sq, d,
                         nullptr, 0, qt);

  float m[4], l[4], acc[4][kG][4];
  zero_acc<kG>(acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
  }
  const int k_end = p.causal ? min(p.sk, q0 + kTile) : p.sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<false, true>(kb, p.k_ss, k0, p.sk, d, nullptr, 0, kt);
    load_tile<true, false>(vb, p.v_ss, k0, p.sk, d, vs, ld, nullptr);
    __syncthreads();
    float s[4][4];
    tile_product(qt, kt, d, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kMask;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = visible(p, qi, k0 + tx * 4 + j);
        s[i][j] *= p.scale;
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[i][g][t] *= corr;
    }
    store_tile(ps, ty, tx, s);
    __syncthreads();
    accumulate<kG>(ps, vs, ld, d4, ty, tx, acc);
  }

  float lnz[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) lnz[i] = fmaxf(l[i], 1e-30f);
  store_rows<kG>(p.out0, ib, ih, p.h, p.sq, q0, d, ty, tx, acc, lnz);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      if (qi < p.sq)
        p.out1[((int64_t)ib * p.h + ih) * p.sq + qi] = m[i] + logf(lnz[i]);
    }
  }
}

size_t smem_bytes(int d) {
  const size_t tr = (size_t)d * kTile, rm = (size_t)kTile * (d + 4);
  return (2 * tr + rm + (size_t)kTile * kPS) * sizeof(float);
}

void* kernel_of(int d) {
  return d <= 64 ? (void*)flash_fwd_kernel<1> : (void*)flash_fwd_kernel<2>;
}

int configure(int d) {
  static bool configured[2] = {};
  const int gi = d <= 64 ? 0 : 1;
  if (configured[gi]) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel_of(d), cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  configured[gi] = true;
  return 0;
}

int launch(const Params& p, int b, cudaStream_t stream) {
  if (p.d % 8 != 0 || p.d <= 0 || p.d > 128) return (int)cudaErrorInvalidValue;
  const int err = configure(p.d);
  if (err) return err;
  dim3 grid((p.sq + kTile - 1) / kTile, b * p.h);
  void* args[] = {(void*)&p};
  cudaError_t e = cudaLaunchKernel(kernel_of(p.d), grid, dim3(kThreads), args,
                                   smem_bytes(p.d), stream);
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
  if (d % 8 != 0 || d <= 0 || d > 128) return (int)cudaErrorInvalidValue;
  int err = configure(d);
  if (err) return err;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel_of(d));
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_of(d), kThreads,
                                                      smem_bytes(d));
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem_bytes(d);
  out[3] = kThreads;
  out[4] = blocks;
  return 0;
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
  Params p{(const float*)q, (const float*)k, (const float*)v, (float*)o,
           (float*)lse, h, sq, sk, d, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, scale, causal};
  return launch(p, b, (cudaStream_t)stream);
}

}  // extern "C"
