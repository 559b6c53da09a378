// Fused short-sequence attention forward for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_fwd_kernel` (launched by `_fused_fwd`) in
// refining_clip_via_dinov2_representations_tpu/ops/fused_attention.py.
// Per (batch*head), for Lq, Lk <= 1024 and head_dim <= 256:
//   S = Q K^T * scale in fp32; if causal, col > row is masked out;
//   P = softmax(S) in fp32, normalised, then cast to V's dtype;
//   O = P V with fp32 accumulation, stored in the input dtype.
// Inputs are contiguous [B*H, L, D] tensors of float32 or bfloat16.
//
// What bounds it on an H100 (published peaks, not measured):
//   * serving image call [32,12,197,64]: 3.82 GFLOP, 77.5 MB in fp32. At the
//     67 TFLOP/s of plain fp32 FMAs it is compute-bound, ~57 us; in bf16 it
//     moves 38.7 MB and is memory-bound, ~11.6 us at 3.35 TB/s.
//   * serving text call [32,8,77,64] causal: ~0.20 GFLOP, 20.2 MB in fp32,
//     memory-bound, ~6.0 us.
// How the design answers that: only Q, K, V and O touch device memory. One
// block owns 32 query rows of one (batch, head) and keeps their whole fp32
// score row (<= 1024 columns) in shared memory, so the softmax is the exact
// full-row softmax of the TPU kernel and P is never written out. K and V are
// staged through shared memory in 64-key tiles that all four warps share.
// Each warp owns 8 query rows: a lane computes 8x2 scores per K tile from
// float4 shared-memory reads (the Q reads are warp-wide broadcasts), and in
// the PV product a lane owns D/32 output columns of the warp's 8 rows, held
// in registers across the V tiles. Causal blocks stop at their last row's
// diagonal tile. All arithmetic is scalar fp32 FMA (no TF32), which keeps the
// fp32 result within 1e-4 of the plain PyTorch version; a tensor-core (wgmma)
// bf16 path is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "fused_attention_common.cuh"

namespace {

using fa::round_like;
using fa::warp_max;
using fa::warp_sum;

constexpr int kThreads = 128;  // four warps
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = (kThreads / 32) * kRowsPerWarp;  // 32 query rows per block
constexpr int kBK = 64;                              // keys per K/V tile

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

template <typename T, int DP>
__device__ __forceinline__ void stage_tile(float* dst, const T* __restrict__ src, int r0,
                                           int rows, int len, int d) {
  fa::stage_tile<T, DP, kThreads>(dst, src, r0, rows, len, d);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    fused_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o, int lq, int lk,
                               int d, float scale, int causal, int lk_pad) {
  constexpr int kStride = DP + 4;  // +4 floats: conflict-free float4 rows
  constexpr int kCols = DP / 32;   // output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][kStride]
  float* kvs = qs + kBQ * kStride;              // [kBK][kStride], K then V tiles
  float* ps = kvs + kBK * kStride;              // [kBQ][lk_pad] scores, then P

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = warp * kRowsPerWarp;  // the warp's first row in the tile
  q += bh * lq * d;
  o += bh * lq * d;
  k += bh * lk * d;
  v += bh * lk * d;

  stage_tile<T, DP>(qs, q, q0, kBQ, lq, d);
  // when causal, keys past the block's last row are masked for all its rows
  const int n_keys = causal ? min(lk, q0 + kBQ) : lk;
  const int n_tiles = (n_keys + kBK - 1) / kBK;

  // ---- S = Q K^T * scale, masked entries -inf ----
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kBK;
    __syncthreads();  // Q staged (t = 0) / previous K tile consumed
    stage_tile<T, DP>(kvs, k, j0, kBK, lk, d);
    __syncthreads();
    float acc[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      const float4 k0 = *reinterpret_cast<const float4*>(&kvs[lane * kStride + c]);
      const float4 k1 = *reinterpret_cast<const float4*>(&kvs[(lane + 32) * kStride + c]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&qs[(row0 + r) * kStride + c]);
        acc[r][0] = fmaf(qv.x, k0.x, acc[r][0]);
        acc[r][0] = fmaf(qv.y, k0.y, acc[r][0]);
        acc[r][0] = fmaf(qv.z, k0.z, acc[r][0]);
        acc[r][0] = fmaf(qv.w, k0.w, acc[r][0]);
        acc[r][1] = fmaf(qv.x, k1.x, acc[r][1]);
        acc[r][1] = fmaf(qv.y, k1.y, acc[r][1]);
        acc[r][1] = fmaf(qv.z, k1.z, acc[r][1]);
        acc[r][1] = fmaf(qv.w, k1.w, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = q0 + row0 + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + lane + 32 * h;
        const bool live = j < n_keys && !(causal && j > row);
        ps[(row0 + r) * lk_pad + j] = live ? acc[r][h] * scale : -INFINITY;
      }
    }
  }

  // ---- P = softmax(S) per row, cast to V's dtype; a warp reads only its rows ----
  const int n_cols = n_tiles * kBK;
  __syncwarp();
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float* prow = ps + (row0 + r) * lk_pad;
    float m = -INFINITY;
    for (int j = lane; j < n_cols; j += 32) m = fmaxf(m, prow[j]);
    m = warp_max(m);  // finite: key 0 is live for every row
    float l = 0.f;
    for (int j = lane; j < n_cols; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < n_cols; j += 32) prow[j] = round_like<T>(prow[j] / l);
  }
  __syncwarp();

  // ---- O = P V, fp32 accumulation in registers ----
  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc[r][cc] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kBK;
    __syncthreads();  // every warp is done with the tile in kvs
    stage_tile<T, DP>(kvs, v, j0, kBK, lk, d);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 p[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        p[r] = *reinterpret_cast<const float4*>(&ps[(row0 + r) * lk_pad + j0 + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const float vv = kvs[(j + jj) * kStride + lane + 32 * cc];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            acc[r][cc] = fmaf(component(p[r], jj), vv, acc[r][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + row0 + r;
    if (row >= lq) continue;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int c = lane + 32 * cc;
      if (c < d) o[(size_t)row * d + c] = fa::from_float<T>(acc[r][cc]);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int lq,
                   int lk, int d, float scale, int causal, cudaStream_t stream) {
  const int lk_pad = (lk + kBK - 1) / kBK * kBK;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * (DP + 4) + (size_t)kBQ * lk_pad);
  auto kernel = fused_attention_fwd_kernel<T, DP>;
  cudaError_t err = fa::reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (lq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), lq, lk,
                                           d, scale, causal, lk_pad);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int bh, int lq,
                     int lk, int d, float scale, int causal, cudaStream_t s) {
  if (d <= 32) return launch<T, 32>(q, k, v, o, bh, lq, lk, d, scale, causal, s);
  if (d <= 64) return launch<T, 64>(q, k, v, o, bh, lq, lk, d, scale, causal, s);
  if (d <= 128) return launch<T, 128>(q, k, v, o, bh, lq, lk, d, scale, causal, s);
  return launch<T, 256>(q, k, v, o, bh, lq, lk, d, scale, causal, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int fused_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int bh, int lq, int lk, int d, float scale, int causal,
                                   int dtype, void* stream) {
  if (bh <= 0 || lq <= 0 || lk <= 0 || lq > 1024 || lk > 1024 || d <= 0 || d > 256)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, bh, lq, lk, d, scale, causal, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, bh, lq, lk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* fused_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
