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
// balanced; in fp32 it moves 303 MB (90 us) and, with three split TF32
// products a FLOP at 495 TFLOP/s, takes 264 us of tensor-core work:
// compute-bound (651 us at the 67 TFLOP/s of plain fp32 FMAs). Only Q, K, V
// and O touch device memory, and shared memory does not grow with the
// sequence length (the gate has no upper bound on it). Causal blocks stop at
// their last row's diagonal tile.
//
// bf16, the training path: tensor cores (`flash_attention_fwd_mma_kernel`,
// building blocks in attention_mma.cuh). A block of four warps owns 64 query
// rows of one (batch, head), each warp 16 rows: the m16 of mma.sync
// m16n8k16. Q, K and V stay bf16 in shared memory, in rows padded by 16
// bytes so ldmatrix reads them without bank conflicts; cp.async copies 16
// bytes at a time where d % 8 == 0 and the bases are aligned (element copies
// otherwise; d is zero-padded to DP). Q is scaled in place once. K and V
// tiles are double-buffered: the next tile's copies are in flight while the
// current one is consumed. S = Q K^T and acc += P V both run on mma.sync
// with fp32 accumulators; S never leaves registers, the row max and sum are
// quad shuffles, and p is rounded to bf16 in registers and repacked from the
// accumulator layout into the A operand of P V. Tiles of 64 keys (32 at
// DP = 256, where the O accumulator alone is 128 registers a thread). A
// warp whose rows all lie past Lq computes nothing, and a tile's keys past
// Lk (or past the warp's last row, when causal) are skipped 16 at a time.
// What still holds it back: mma.sync runs from each warp in turn at a
// fraction of the wgmma rate and needs every operand through ldmatrix; one
// __syncthreads a tile with four warps a block; an exact expf on every
// score (to keep p's rounding); no warp specialisation. wgmma on TMA-fed
// tiles is the next step.
//
// fp32 with head_dim <= 128 (`--attn-impl flash` under --precision amp or
// fp32, and "fused" calls past 1024 tokens): tensor cores
// (`flash_attention_fwd_tf32_kernel`), split-TF32 products that keep fp32
// accuracy (within 1e-4 of the plain version; one TF32 product misses that).
// Its body is the fused kernel's fp32 forward, shared in
// attention_fwd_tf32.cuh and templated on what differs: Q is scaled once
// in fp32 where its tile lands in shared memory (the TPU kernel's rounding
// point), then split into hi and lo; masked keys are -1e30; O = acc /
// max(l, 1e-30). In fp32 the TPU kernel's cast of P to V's dtype is the
// identity, so the one online pass in base 2 (the pre-scaled scores times
// log2(e), exp2) computes its function up to fp32 rounding. 64 query rows a
// block (the query-length bound counts 64-row tiles), K and V in 32-key
// tiles of one double-buffered cp.async stream, P kept in registers; four
// blocks an SM up to DP = 64, Q's fragments read from shared memory from
// DP = 64 on (tuned at 577 tokens: PERF.md).
// Bound: the larger of 3 x FLOPs at 495 TFLOP/s and the bytes at 3.35 TB/s.
// What still holds it back: three m16n8k8 products for each product; the
// split's integer operations on every K and V fragment read; mma.sync
// instead of wgmma; at 577 tokens each head's last 64-row block holds one
// live row of 64 (10 % of the blocks).
//
// fp32 with head_dim > 128 (no registry model has such heads): the first
// port's scalar kernel, a documented route by shape, as in the fused
// forward. One block owns 32 query rows; a warp owns 8: a lane computes 8x2
// scores per 64-key tile from float4 shared-memory reads, the row
// statistics are warp reductions, P goes through a 32 x 64 shared tile, and
// in the PV product a lane owns D/32 output columns of the warp's 8 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "attention_fwd_tf32.cuh"
#include "attention_mma.cuh"
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

// The bf16 tensor-core kernel; see the note at the top. `vec`: 16-byte
// copies (d % 8 == 0, aligned bases) instead of element copies.
template <int DP>
__global__ void __launch_bounds__(fa::kMmaThreads, fa::mma_min_blocks<DP>())
    flash_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   __nv_bfloat16* __restrict__ o, int lq, int lk, int d,
                                   float scale, int causal, int vec) {
  constexpr int kRows = fa::kMmaRows;
  constexpr int kTile = fa::mma_key_tile<DP>();
  constexpr int kStride = fa::mma_stride<DP>();
  constexpr bool kQRegs = DP <= 128;  // Q fragments held in registers
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [kRows][kStride]
  __nv_bfloat16* kv = qs + kRows * kStride;  // two buffers of K then V, [kTile][kStride] each

  size_t bh;
  int q0;
  fa::mma_block_coords((lq + kRows - 1) / kRows, &bh, &q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  q += bh * lq * d;
  o += bh * lq * d;
  k += bh * lk * d;
  v += bh * lk * d;

  // when causal, keys past the block's last row are masked for all its rows
  const int n_keys = causal ? min(lk, q0 + kRows) : lk;
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  auto load_kv = [&](int t) {
    __nv_bfloat16* buf = kv + (t & 1) * 2 * kTile * kStride;
    fa::load_tile<DP, kTile>(buf, k, t * kTile, lk, d, vec);
    fa::load_tile<DP, kTile>(buf + kTile * kStride, v, t * kTile, lk, d, vec);
  };

  fa::load_tile<DP, kRows>(qs, q, q0, lq, d, vec);
  load_kv(0);
  fa::cp_async_commit();
  fa::cp_async_wait<0>();
  __syncthreads();
  // Q pre-scaled and rounded in bf16, the scale rounded to bf16 first
  const float sc = __bfloat162float(__float2bfloat16(scale));
  for (int i = threadIdx.x; i < kRows * DP / 2; i += fa::kMmaThreads) {
    __nv_bfloat162* x2 =
        reinterpret_cast<__nv_bfloat162*>(qs + (i / (DP / 2)) * kStride + (i % (DP / 2)) * 2);
    const float2 x = __bfloat1622float2(*x2);
    *x2 = __floats2bfloat162_rn(x.x * sc, x.y * sc);
  }
  __syncthreads();

  const __nv_bfloat16* qw = qs + warp * 16 * kStride;  // the warp's 16 rows
  uint32_t qf[kQRegs ? DP / 16 : 1][4];
  if constexpr (kQRegs) fa::load_q_frags<DP>(qf, qw, lane);

  // a lane's rows: row_lo (accumulator elements 0, 1) and row_lo + 8 (2, 3)
  const int warp_row0 = q0 + warp * 16;
  const int row_lo = warp_row0 + (lane >> 2);
  const int col = (lane & 3) * 2;
  // a warp past lq has nothing to compute; keys from warp_keys on are padding
  // or causal-masked for all the warp's rows, and are skipped
  const bool warp_live = warp_row0 < lq;
  const int warp_keys = causal ? min(lk, warp_row0 + 16) : lk;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};  // l: this lane's part of the row sum
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // One tile: S on tensor cores, the online softmax, acc += P V. PARTIAL:
  // keys from n_live on are not computed (a separate instantiation, so full
  // tiles keep straight-line code).
  auto step = [&](const __nv_bfloat16* ks, int j0, int n_live, auto partial) {
    constexpr bool kPartial = decltype(partial)::value;
    float s[kTile / 8][4];
    fa::tile_scores<DP, kTile, kQRegs, kPartial>(s, qf, qw, ks, n_live, lane);
    if (j0 + kTile > lk || (causal && j0 + kTile - 1 > warp_row0)) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + n * 8 + col + (e & 1);
          if (j >= lk || (causal && j > row_lo + (e >> 1) * 8)) s[n][e] = kMasked;
        }
    }

    // online softmax: m_new, p = exp(s - m_new) in fp32 (kept in s), rescale
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fa::quad_max(mx);  // finite after the first tile: key 0 is live for every row
      const float alpha = expf(m[h] - mx);
      m[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const bool live = !kPartial || n * 8 < n_live;
        s[n][2 * h] = live ? expf(s[n][2 * h] - mx) : 0.f;
        s[n][2 * h + 1] = live ? expf(s[n][2 * h + 1] - mx) : 0.f;
        sum += s[n][2 * h] + s[n][2 * h + 1];
      }
      l[h] = l[h] * alpha + sum;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
    }
    // p rounded to bf16 there
    fa::tile_pv<DP, kTile, kPartial>(acc, s, ks + kTile * kStride, n_live, lane);
  };

  for (int t = 0; t < n_tiles; ++t) {
    fa::cp_async_wait<0>();
    // tile t has landed for every thread, and every warp is done with tile
    // t - 1, whose buffer now takes tile t + 1 while tile t is consumed
    __syncthreads();
    if (t + 1 < n_tiles) load_kv(t + 1);
    fa::cp_async_commit();
    const int j0 = t * kTile;
    const int n_live = min(kTile, warp_keys - j0);
    const __nv_bfloat16* ks = kv + (t & 1) * 2 * kTile * kStride;
    if (warp_live && n_live == kTile) step(ks, j0, n_live, fa::Flag<false>{});
    else if (warp_live && n_live > 0) step(ks, j0, n_live, fa::Flag<true>{});
  }
  if (!warp_live) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float denom = fmaxf(fa::quad_sum(l[h]), 1e-30f);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][2 * h] /= denom;
      acc[n][2 * h + 1] /= denom;
    }
  }
  fa::store_rows<DP>(o, acc, qs + warp * 16 * kStride, warp_row0, lq, d, vec, lane);
}

// The fp32 tensor-core kernel (split-TF32 products) up to head dim 128; its
// body, shared with the fused kernel's fp32 route, is in
// attention_fwd_tf32.cuh.
template <int DP>
__global__ void __launch_bounds__(fa::kMmaThreads, (fa::tf32_min_blocks<DP, true>()))
    flash_attention_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, float* __restrict__ o, int lq,
                                    int lk, int d, float scale, int causal, int vec) {
  fa::attention_fwd_tf32<DP, true>(q, k, v, o, lq, lk, d, scale, causal, vec);
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

// fp32 by head_dim: the tensor-core kernel up to 128; past it (no registry
// model has such heads) the scalar kernel, whose O accumulator fits
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o, int bh, int lq,
                         int lk, int d, float scale, int causal, cudaStream_t s) {
  if (d <= 32)
    return fa::launch_fwd_tf32<32>(flash_attention_fwd_tf32_kernel<32>, q, k, v, o, bh, lq, lk, d,
                                   scale, causal, s);
  if (d <= 64)
    return fa::launch_fwd_tf32<64>(flash_attention_fwd_tf32_kernel<64>, q, k, v, o, bh, lq, lk, d,
                                   scale, causal, s);
  if (d <= 128)
    return fa::launch_fwd_tf32<128>(flash_attention_fwd_tf32_kernel<128>, q, k, v, o, bh, lq, lk,
                                    d, scale, causal, s);
  return launch<float, 256>(q, k, v, o, bh, lq, lk, d, scale, causal, s);
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int bh, int lq,
                       int lk, int d, float scale, int causal, cudaStream_t stream) {
  // independent of the sequence lengths: 101,376 bytes at DP = 256
  const size_t smem = sizeof(__nv_bfloat16) *
                      (size_t)(fa::kMmaRows + 4 * fa::mma_key_tile<DP>()) * fa::mma_stride<DP>();
  auto kernel = flash_attention_fwd_mma_kernel<DP>;
  cudaError_t err = fa::reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 && fa::aligned16(q) && fa::aligned16(k) && fa::aligned16(v) &&
                  fa::aligned16(o);
  const dim3 grid(bh, (lq + fa::kMmaRows - 1) / fa::kMmaRows);
  kernel<<<grid, fa::kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lq, lk, d, scale,
      causal, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* o, int bh, int lq,
                         int lk, int d, float scale, int causal, cudaStream_t s) {
  if (d <= 32) return launch_mma<32>(q, k, v, o, bh, lq, lk, d, scale, causal, s);
  if (d <= 64) return launch_mma<64>(q, k, v, o, bh, lq, lk, d, scale, causal, s);
  if (d <= 128) return launch_mma<128>(q, k, v, o, bh, lq, lk, d, scale, causal, s);
  return launch_mma<256>(q, k, v, o, bh, lq, lk, d, scale, causal, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int bh, int lq, int lk, int d, float scale, int causal,
                                   int dtype, void* stream) {
  if (bh <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > 256) return cudaErrorInvalidValue;
  // the grid's second dimension counts query tiles, at most 65535 of them:
  // 64 rows in the tensor-core kernels, 32 in the scalar one (fp32 past 128)
  const long long rows = dtype == 0 && d > 128 ? kBQ : fa::kMmaRows;
  if (lq > 65535 * rows) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(q, k, v, o, bh, lq, lk, d, scale, causal, s);
  if (dtype == 1) return dispatch_mma(q, k, v, o, bh, lq, lk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
