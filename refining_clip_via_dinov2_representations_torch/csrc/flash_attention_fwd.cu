// Blockwise flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_flash_fwd_kernel` (launched by
// `_flash_forward`) in refining_clip_via_dinov2_representations_tpu/ops/flash_attention.py.
// Per (batch*head), for any Lq, Lk >= 1 and head_dim <= 256, with the TPU
// kernel's rounding points:
//   Q is pre-scaled in the input dtype (q * scale, the scale rounded first);
//   S = Q K^T with fp32 accumulation; keys past Lk and, if causal, keys past
//   the query's index are set to -1e30;
//   a running max m and sum l in fp32: p = exp(s - m_new) in fp32 feeds l,
//   p rounded to V's dtype feeds acc += P V (fp32), both rescaled by
//   exp(m - m_new);
//   O = acc / max(l, 1e-30), stored in the input dtype.
// Inputs are contiguous [B*H, L, D] tensors of float32 or bfloat16.
//
// What bounds it on an H100 (published peaks, not measured): the ViT-L-14-336
// vision call [32,16,577,64] is 43.6 GFLOP over 151 MB in bf16, about 45 us
// at 3.35 TB/s and 44 us at the 989 TFLOP/s bf16 tensor-core rate, so
// balanced; in fp32 it moves 303 MB but takes 651 us at the 67 TFLOP/s of
// plain fp32 FMAs, compute-bound.
// How the design answers that: only Q, K, V and O touch device memory, and
// shared memory does not grow with the sequence length (the gate has no upper
// bound on it). One block owns 32 query rows of one (batch, head); their
// pre-scaled Q stays in shared memory while K and V stream through it in
// 64-key tiles that all four warps share. Each warp owns 8 query rows: a lane
// computes 8x2 scores per K tile from float4 shared-memory reads (the Q reads
// are warp-wide broadcasts), the row statistics are warp reductions, P goes
// through a 32 x 64 shared tile, and in the PV product a lane owns D/32
// output columns of the warp's 8 rows, held in registers across the tiles.
// Causal blocks stop at their last row's diagonal tile. All arithmetic is
// scalar fp32 FMA (no TF32, no tensor cores): the fp32 result stays within
// 1e-4 of the plain PyTorch version, and in bf16 the kernel is far from its
// tensor-core bound by construction; an mma/wgmma path is later work.

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
constexpr int kPStride = kBK + 4;                    // P tile row, float4-aligned
constexpr float kMasked = -1e30f;                    // the TPU kernel's NEG_INF

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o, int lq, int lk,
                               int d, float scale, int causal) {
  constexpr int kStride = DP + 4;  // +4 floats: conflict-free float4 rows
  constexpr int kCols = DP / 32;   // output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][kStride], Q * scale in T
  float* ks = qs + kBQ * kStride;               // [kBK][kStride]
  float* vs = ks + kBK * kStride;               // [kBK][kStride]
  float* ps = vs + kBK * kStride;               // [kBQ][kPStride], P rounded to T

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = warp * kRowsPerWarp;  // the warp's first row in the tile
  q += bh * lq * d;
  o += bh * lq * d;
  k += bh * lk * d;
  v += bh * lk * d;

  // Q pre-scaled and rounded in the input dtype, zero past lq rows / d columns
  const float sc = round_like<T>(scale);
  for (int i = threadIdx.x; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (q0 + r < lq && c < d) x = round_like<T>(fa::to_float(q[(size_t)(q0 + r) * d + c]) * sc);
    qs[r * kStride + c] = x;
  }
  // when causal, keys past the block's last row are masked for all its rows
  const int n_keys = causal ? min(lk, q0 + kBQ) : lk;
  const int n_tiles = (n_keys + kBK - 1) / kBK;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc[r][cc] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kBK;
    __syncthreads();  // Q staged (t = 0) / the previous K and V tiles consumed
    fa::stage_tile<T, DP, kThreads>(ks, k, j0, kBK, lk, d);
    fa::stage_tile<T, DP, kThreads>(vs, v, j0, kBK, lk, d);
    __syncthreads();

    // ---- S = (Q * scale) K^T: a lane owns keys lane and lane + 32 ----
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      const float4 k0 = *reinterpret_cast<const float4*>(&ks[lane * kStride + c]);
      const float4 k1 = *reinterpret_cast<const float4*>(&ks[(lane + 32) * kStride + c]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&qs[(row0 + r) * kStride + c]);
        s[r][0] = fmaf(qv.x, k0.x, s[r][0]);
        s[r][0] = fmaf(qv.y, k0.y, s[r][0]);
        s[r][0] = fmaf(qv.z, k0.z, s[r][0]);
        s[r][0] = fmaf(qv.w, k0.w, s[r][0]);
        s[r][1] = fmaf(qv.x, k1.x, s[r][1]);
        s[r][1] = fmaf(qv.y, k1.y, s[r][1]);
        s[r][1] = fmaf(qv.z, k1.z, s[r][1]);
        s[r][1] = fmaf(qv.w, k1.w, s[r][1]);
      }
    }

    // ---- online softmax: the warp's rows, statistics by warp reductions ----
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = q0 + row0 + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + lane + 32 * h;
        if (j >= lk || (causal && j > row)) s[r][h] = kMasked;
      }
      // finite after the first tile: key 0 is live for every row
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) acc[r][cc] *= alpha;
      ps[(row0 + r) * kPStride + lane] = round_like<T>(p0);
      ps[(row0 + r) * kPStride + lane + 32] = round_like<T>(p1);
    }
    __syncwarp();  // a warp reads only its own P rows

    // ---- acc += P V, fp32 accumulation in registers ----
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 p[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        p[r] = *reinterpret_cast<const float4*>(&ps[(row0 + r) * kPStride + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const float vv = vs[(j + jj) * kStride + lane + 32 * cc];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            acc[r][cc] = fmaf(component(p[r], jj), vv, acc[r][cc]);
        }
      }
    }
    __syncwarp();  // P read before the next tile's rows overwrite it
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + row0 + r;
    if (row >= lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int c = lane + 32 * cc;
      if (c < d) o[(size_t)row * d + c] = fa::from_float<T>(acc[r][cc] / denom);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int lq,
                   int lk, int d, float scale, int causal, cudaStream_t stream) {
  // independent of the sequence lengths: 175,104 bytes at DP = 256
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (DP + 4) + (size_t)kBQ * kPStride);
  auto kernel = flash_attention_fwd_kernel<T, DP>;
  cudaError_t err = fa::reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (lq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), lq, lk,
                                           d, scale, causal);
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
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int bh, int lq, int lk, int d, float scale, int causal,
                                   int dtype, void* stream) {
  if (bh <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > 256 || lq > 65535 * kBQ)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, bh, lq, lk, d, scale, causal, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, bh, lq, lk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
