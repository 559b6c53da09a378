// Fused short-sequence attention backward for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_bwd_kernel` (launched by `_fused_bwd`, the
// VJP `_fa_bwd` of `fused_attention`) in
// refining_clip_via_dinov2_representations_tpu/ops/fused_attention.py.
// Per (batch*head), for Lq, Lk <= 1024 and head_dim <= 256, from the
// residuals q, k, v, o and the cotangent dO, with the TPU kernel's rounding
// points (T is the input dtype, float32 or bfloat16):
//   P  = softmax(Q K^T * scale) in fp32, causal col > row masked, exactly as
//        the forward kernel computes it;
//   dV = (P cast to T)^T dO, fp32 accumulation;
//   dP = dO V^T in fp32;  delta = rowsum(dO * O) in fp32 from the stored O;
//   dS = (P * (dP - delta)) cast to T, from the fp32 P;
//   dQ = (dS K) * scale,  dK = (dS^T Q) * scale, the scale applied to the fp32
//        sums; every output is stored in T.
// Inputs are contiguous [B*H, L, D] tensors.
//
// What bounds it on an H100 (published SXM peaks: 67 TFLOP/s fp32 FMA,
// 989 TFLOP/s bf16, 3.35 TB/s; not measured). The work is 10 * pairs * D
// FLOPs per head (S recomputed, dV, dP, dQ, dK) and 8 * L * D elements moved
// per head (q, k, v, o, dO in; dq, dk, dv out):
//   * training image call [64,12,197,64]: 19.08 GFLOP; in fp32 310 MB moved,
//     operations-bound, ~285 us; in bf16 155 MB, bytes-bound, ~46 us.
//   * training text call [64,8,77,64] causal: 0.98 GFLOP; in fp32 81 MB,
//     bytes-bound, ~24 us; in bf16 40 MB, bytes-bound, ~12 us.
// How the design answers that (simple and correct first; no tensor cores):
// two kernels, no atomics, so the result does not depend on launch order.
//   1. `fused_attention_bwd_dq_kernel`: one block owns 32 query rows of one
//      (batch, head). Two passes over 32-key tiles give each row's max m and sum l of the fp32
//      softmax (each lane sums its own keys, then one warp sum: the forward
//      kernel's order, so P is the forward's P bit for bit); delta comes from
//      O and dO; a third pass forms dS per tile in shared memory and
//      accumulates dQ in registers. It writes m, l and delta to a scratch
//      buffer for the second kernel.
//   2. `fused_attention_bwd_dkdv_kernel`: one block owns 32 keys; K and V
//      stay in shared memory while it walks the 32-row query tiles (from the key tile's diagonal
//      when causal), recomputes P from (m, l), forms P-in-T and dS tiles, and
//      accumulates dK and dV in registers.
// Score products are scalar fp32 FMAs from float4 shared-memory reads, as in
// the forward kernel. Shared memory is 4 tiles of 32 x (D+4) floats plus two
// 32 x 33 tiles: 141.6 KB at D = 256, so every shape the gate admits fits.
// S and dP are computed twice and S four times in all: a wgmma/TMA bf16 path
// that keeps one pass is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "fused_attention_common.cuh"

namespace {

using fa::round_like;
using fa::warp_max;
using fa::warp_sum;

constexpr int kThreads = 256;               // eight warps
constexpr int kTile = 32;                   // query rows per tile = keys per tile
constexpr int kRows = kTile / (kThreads / 32);  // 4 tile rows per warp
constexpr int kPStride = kTile + 1;         // [kTile][kTile + 1] P / dS tiles

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * (size_t)kTile * (DP + 4) + 2 * (size_t)kTile * kPStride);
}

template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0, int len,
                                      int d) {
  fa::stage_tile<T, DP, kThreads>(dst, src, r0, kTile, len, d);
}

// out[r] = dot(a[row0 + r], b[lane]) over DP columns for this warp's kRows tile
// rows and the lane's key column: the forward kernel's FMA order, so S here
// equals the forward's S bit for bit.
template <int DP>
__device__ __forceinline__ void row_dots(const float* a, const float* b, int row0, int lane,
                                         float out[kRows]) {
  constexpr int kStride = DP + 4;
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(&b[lane * kStride + c]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(&a[(row0 + r) * kStride + c]);
      out[r] = fmaf(av.x, bv.x, out[r]);
      out[r] = fmaf(av.y, bv.y, out[r]);
      out[r] = fmaf(av.z, bv.z, out[r]);
      out[r] = fmaf(av.w, bv.w, out[r]);
    }
  }
}

__device__ __forceinline__ bool live(int row, int col, int lq, int lk, int causal) {
  return row < lq && col < lk && !(causal && col > row);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    fused_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const T* __restrict__ o,
                                  const T* __restrict__ dout, T* __restrict__ dq,
                                  float* __restrict__ stats, int bh_total, int lq, int lk, int d,
                                  float scale, int causal) {
  constexpr int kStride = DP + 4;
  constexpr int kCols = DP / 32;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kTile][kStride]
  float* dos = qs + kTile * kStride;             // dO tile
  float* ks = dos + kTile * kStride;             // K tile
  float* vs = ks + kTile * kStride;              // V tile
  float* dss = vs + kTile * kStride;             // [kTile][kPStride] dS (in T)

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = warp * kRows;  // the warp's first row in the tile
  q += bh * lq * d;
  o += bh * lq * d;
  dout += bh * lq * d;
  dq += bh * lq * d;
  k += bh * lk * d;
  v += bh * lk * d;

  stage<T, DP>(qs, q, q0, lq, d);
  stage<T, DP>(dos, dout, q0, lq, d);

  // delta = rowsum(dO * O) in fp32, from the stored (rounded) O
  float delta[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + row0 + r;
    float part = 0.f;
    if (row < lq)
      for (int c = lane; c < d; c += 32)
        part = fmaf(fa::to_float(dout[(size_t)row * d + c]), fa::to_float(o[(size_t)row * d + c]),
                    part);
    delta[r] = warp_sum(part);
  }

  // when causal, keys past the block's last row are masked for all its rows
  const int n_keys = causal ? min(lk, q0 + kTile) : lk;
  const int n_tiles = (n_keys + kTile - 1) / kTile;

  // ---- pass 1: row max of S * scale ----
  float m[kRows], s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) m[r] = -INFINITY;
  for (int t = 0; t < n_tiles; ++t) {
    const int j = t * kTile + lane;
    __syncthreads();  // Q/dO staged (t = 0) / previous K tile consumed
    stage<T, DP>(ks, k, t * kTile, lk, d);
    __syncthreads();
    row_dots<DP>(qs, ks, row0, lane, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (live(q0 + row0 + r, j, lq, n_keys, causal)) m[r] = fmaxf(m[r], s[r] * scale);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) m[r] = warp_max(m[r]);  // finite for live rows: key 0

  // ---- pass 2: row sum of exp(S * scale - m), lane-local then one warp sum ----
  float l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) l[r] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int j = t * kTile + lane;
    __syncthreads();
    stage<T, DP>(ks, k, t * kTile, lk, d);
    __syncthreads();
    row_dots<DP>(qs, ks, row0, lane, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (live(q0 + row0 + r, j, lq, n_keys, causal)) l[r] += expf(s[r] * scale - m[r]);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) l[r] = warp_sum(l[r]);

  // ---- pass 3: dS per tile, dQ += dS K ----
  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc[r][cc] = 0.f;
  float dp[kRows];
  for (int t = 0; t < n_tiles; ++t) {
    const int j = t * kTile + lane;
    __syncthreads();
    stage<T, DP>(ks, k, t * kTile, lk, d);
    stage<T, DP>(vs, v, t * kTile, lk, d);
    __syncthreads();
    row_dots<DP>(qs, ks, row0, lane, s);
    row_dots<DP>(dos, vs, row0, lane, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float ds = 0.f;
      if (live(q0 + row0 + r, j, lq, n_keys, causal)) {
        const float p = expf(s[r] * scale - m[r]) / l[r];
        ds = round_like<T>(p * (dp[r] - delta[r]));
      }
      dss[(row0 + r) * kPStride + lane] = ds;
    }
    __syncwarp();  // the warp reads back only its own dS rows
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float kv = ks[jj * kStride + lane + 32 * cc];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r][cc] = fmaf(dss[(row0 + r) * kPStride + jj], kv, acc[r][cc]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + row0 + r;
    if (row >= lq) continue;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int c = lane + 32 * cc;
      if (c < d) dq[(size_t)row * d + c] = fa::from_float<T>(acc[r][cc] * scale);
    }
    if (lane == 0) {
      const size_t i = bh * lq + row;
      stats[i] = m[r];
      stats[(size_t)bh_total * lq + i] = l[r];
      stats[2 * (size_t)bh_total * lq + i] = delta[r];
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    fused_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v, const T* __restrict__ dout,
                                    const float* __restrict__ stats, T* __restrict__ dk,
                                    T* __restrict__ dv, int bh_total, int lq, int lk, int d,
                                    float scale, int causal) {
  constexpr int kStride = DP + 4;
  constexpr int kCols = DP / 32;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // Q tile
  float* dos = qs + kTile * kStride;             // dO tile
  float* ks = dos + kTile * kStride;             // this block's K tile
  float* vs = ks + kTile * kStride;              // this block's V tile
  float* ps = vs + kTile * kStride;              // [kTile][kPStride] P in T
  float* dss = ps + kTile * kPStride;            // [kTile][kPStride] dS in T

  const size_t bh = blockIdx.x;
  const int j0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = warp * kRows;
  q += bh * lq * d;
  dout += bh * lq * d;
  k += bh * lk * d;
  v += bh * lk * d;
  dk += bh * lk * d;
  dv += bh * lk * d;
  const float* m = stats + bh * lq;
  const float* l = stats + (size_t)bh_total * lq + bh * lq;
  const float* delta = stats + 2 * (size_t)bh_total * lq + bh * lq;

  stage<T, DP>(ks, k, j0, lk, d);
  stage<T, DP>(vs, v, j0, lk, d);

  float acc_dk[kRows][kCols], acc_dv[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc_dk[r][cc] = acc_dv[r][cc] = 0.f;

  // when causal, query rows before the key tile see none of its keys
  const int first_tile = causal ? j0 / kTile : 0;
  const int n_qtiles = (lq + kTile - 1) / kTile;
  const int j = j0 + lane;
  float s[kRows], dp[kRows];
  for (int t = first_tile; t < n_qtiles; ++t) {
    const int q0 = t * kTile;
    __syncthreads();  // K/V staged (first pass) / previous Q, dO, P, dS tiles consumed
    stage<T, DP>(qs, q, q0, lq, d);
    stage<T, DP>(dos, dout, q0, lq, d);
    __syncthreads();
    // the warp's rows of the query tile against the lane's key
    row_dots<DP>(qs, ks, row0, lane, s);
    row_dots<DP>(dos, vs, row0, lane, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + row0 + r;
      float p_in = 0.f, ds = 0.f;
      if (live(row, j, lq, lk, causal)) {
        const float p = expf(s[r] * scale - m[row]) / l[row];
        p_in = round_like<T>(p);
        ds = round_like<T>(p * (dp[r] - delta[row]));
      }
      ps[(row0 + r) * kPStride + lane] = p_in;
      dss[(row0 + r) * kPStride + lane] = ds;
    }
    __syncthreads();  // every warp reads every row of the P and dS tiles
    // dV[key] += P_in[i][key] dO[i], dK[key] += dS[i][key] Q[i]: the thread
    // owns keys row0 + r of the block's tile and columns lane + 32 cc
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float dov = dos[i * kStride + lane + 32 * cc];
        const float qv = qs[i * kStride + lane + 32 * cc];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc_dv[r][cc] = fmaf(ps[i * kPStride + row0 + r], dov, acc_dv[r][cc]);
          acc_dk[r][cc] = fmaf(dss[i * kPStride + row0 + r], qv, acc_dk[r][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = j0 + row0 + r;
    if (key >= lk) continue;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int c = lane + 32 * cc;
      if (c < d) {
        dk[(size_t)key * d + c] = fa::from_float<T>(acc_dk[r][cc] * scale);
        dv[(size_t)key * d + c] = fa::from_float<T>(acc_dv[r][cc]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float* stats;
  int bh, lq, lk, d;
  float scale;
  int causal;
};

template <typename T, int DP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  auto k1 = fused_attention_bwd_dq_kernel<T, DP>;
  auto k2 = fused_attention_bwd_dkdv_kernel<T, DP>;
  cudaError_t err = fa::reserve_smem(k1, smem);
  if (err != cudaSuccess) return err;
  err = fa::reserve_smem(k2, smem);
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  k1<<<dim3(a.bh, (a.lq + kTile - 1) / kTile), kThreads, smem, stream>>>(
      q, k, v, static_cast<const T*>(a.o), dout, static_cast<T*>(a.dq), a.stats, a.bh, a.lq,
      a.lk, a.d, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<dim3(a.bh, (a.lk + kTile - 1) / kTile), kThreads, smem, stream>>>(
      q, k, v, dout, a.stats, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.bh, a.lq, a.lk,
      a.d, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.d <= 32) return launch<T, 32>(a, s);
  if (a.d <= 64) return launch<T, 64>(a, s);
  if (a.d <= 128) return launch<T, 128>(a, s);
  return launch<T, 256>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `stats` is fp32 scratch of 3 * bh * lq
// floats (row max, row sum, delta). Returns a cudaError_t (0 on success).
extern "C" int fused_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* stats,
                                   int bh, int lq, int lk, int d, float scale, int causal,
                                   int dtype, void* stream) {
  if (bh <= 0 || lq <= 0 || lk <= 0 || lq > 1024 || lk > 1024 || d <= 0 || d > 256)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, dq, dk, dv, static_cast<float*>(stats),
               bh, lq, lk, d, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* fused_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
