// The fp32 attention forward on tensor cores (split TF32), one body for two
// kernels: `fused_attention_fwd_tf32_kernel` (fused_attention_fwd.cu, the
// TPU's `_fwd_kernel`) and `flash_attention_fwd_tf32_kernel`
// (flash_attention_fwd.cu, the TPU's `_flash_fwd_kernel`). In fp32 the TPU
// kernels' cast of P to V's dtype is the identity, so one online-softmax
// pass that divides after P V computes both functions up to fp32 rounding;
// what differs is a template flag, FLASH:
//
//   FLASH false (`_fwd_kernel`): S = Q K^T, times scale; masked keys -inf;
//     O = acc / l.
//   FLASH true (`_flash_fwd_kernel`): Q pre-scaled once, in fp32 where its
//     tile lands in shared memory (q * scale, as `q_ref * scale` in the input
//     dtype), before it is split into hi and lo; S = (Q scale) K^T; masked
//     keys -1e30 and m starting at -1e30 (the TPU kernel's NEG_INF);
//     O = acc / max(l, 1e-30).
//
// Both take the softmax in base 2: the scores times log2(e) (times scale
// as well where Q is not pre-scaled), p = 2^(s - m). That is
// e^(S scale - M) up to fp32 rounding, one multiply and one MUFU.EX2 a
// score. Every row sees a live key in its first tile (key 0; a warp's rows
// past Lq too), so alpha = 2^(m_old - m_new) is 0 on the first tile with
// either mask value and l >= 1 at the end.
//
// The block: 64 query rows, four warps of m16, K and V in 32-key tiles of
// one double-buffered cp.async stream, fp32 rows of DP + 4 floats (one pad
// serves ldmatrix and the permuted column reads; attention_tf32.cuh).
// Shared memory does not grow with Lk. Q's hi and lo fragments stay in
// registers up to DP = 64 (fused) or 32 (flash; see tf32_q_regs). P never leaves
// registers: an S accumulator becomes the A operand of P V in a permuted k
// order, with V's rows read in the same order. K and V are split where they
// are read (scripts/tune_attention_bwd.py times the other choices).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "attention_mma.cuh"
#include "attention_tf32.cuh"
#include "fused_attention_common.cuh"

namespace fa {

// Q fragments held in registers (hi and lo), split once. The fused kernel
// holds them up to DP = 64, three blocks an SM. The flash kernel holds them
// at DP = 32 only: from DP = 64 on it reads them from shared memory and
// splits them on every read, which frees the registers for four blocks an
// SM. That ran faster at 577 tokens, and at the fused kernel's batch-32 and
// batch-64 calls, but slower at its batch-8 serving calls (PERF.md).
template <int DP, bool FLASH>
__host__ __device__ constexpr bool tf32_q_regs() { return DP <= (FLASH ? 32 : 64); }
// blocks an SM should hold up to DP = 64 (three: at most 168 registers a
// thread; four: 128); two at DP = 128
template <int DP, bool FLASH>
__host__ __device__ constexpr int tf32_min_blocks() { return DP <= 64 ? (FLASH ? 4 : 3) : 2; }

// The block's work; see the note at the top. `vec`: 16-byte copies (d % 4
// == 0, aligned bases).
template <int DP, bool FLASH>
__device__ __forceinline__ void attention_fwd_tf32(const float* __restrict__ q,
                                                   const float* __restrict__ k,
                                                   const float* __restrict__ v,
                                                   float* __restrict__ o, int lq, int lk, int d,
                                                   float scale, int causal, int vec) {
  constexpr int kRows = kMmaRows;
  constexpr int kTile = kTf32Tile;
  constexpr int kStride = tf32_stride<DP>();
  constexpr bool kQRegs = tf32_q_regs<DP, FLASH>();
  constexpr int kPlane = kTile * kStride;  // one K or V tile
  const float kMasked = FLASH ? -1e30f : -INFINITY;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][kStride]
  float* kv = qs + kRows * kStride;             // two buffers of a K then a V tile

  size_t bh;
  int q0;
  mma_block_coords((lq + kRows - 1) / kRows, &bh, &q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  q += bh * lq * d;
  o += bh * lq * d;
  k += bh * lk * d;
  v += bh * lk * d;

  // when causal, keys past the block's last row are masked for all its rows
  const int n_keys = causal ? min(lk, q0 + kRows) : lk;
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  auto load_step = [&](int t) {  // key tile t: its K and V rows
    float* buf = kv + (t & 1) * 2 * kPlane;
    load_tile_f32<DP, kTile>(buf, k, t * kTile, lk, d, vec);
    load_tile_f32<DP, kTile>(buf + kPlane, v, t * kTile, lk, d, vec);
  };

  load_tile_f32<DP, kRows>(qs, q, q0, lq, d, vec);
  load_step(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float* qw = qs + warp * 16 * kStride;  // the warp's 16 rows, read by it alone
  if constexpr (FLASH) {
    // Q pre-scaled in fp32 and rounded there, before its fragments are split
    for (int i = lane; i < 16 * DP / 4; i += 32) {
      float4* x = reinterpret_cast<float4*>(qw + (i / (DP / 4)) * kStride + (i % (DP / 4)) * 4);
      const float4 y = *x;
      *x = make_float4(y.x * scale, y.y * scale, y.z * scale, y.w * scale);
    }
    __syncwarp();
  }
  uint32_t qf[kQRegs ? DP / 8 : 1][2][4];
  if constexpr (kQRegs) load_a_frags<DP>(qf, qw, lane);

  // a lane's rows: row_lo (accumulator elements 0, 1) and row_lo + 8 (2, 3)
  const int warp_row0 = q0 + warp * 16;
  const int row_lo = warp_row0 + (lane >> 2);
  const int col = (lane & 3) * 2;
  // a warp past lq has nothing to compute; keys from warp_keys on are padding
  // or causal-masked for all the warp's rows, and are skipped
  const bool warp_live = warp_row0 < lq;
  const int warp_keys = causal ? min(lk, warp_row0 + 16) : lk;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // One key tile: S = Q K^T * scale2, masked entries (padding, col > row)
  // kMasked; the running max and sum in base 2; acc rescaled, then acc +=
  // P V with the unnormalised p. PARTIAL: keys from n_live on are not
  // computed.
  const float scale2 = FLASH ? kLog2e : scale * kLog2e;
  auto step = [&](const float* ks, int j0, int n_live, auto partial) {
    constexpr bool kPartial = decltype(partial)::value;
    float s[kTile / 8][4];
    tile_scores_f32<DP, kTile, kQRegs, kPartial, 0, 0>(s, qf, qw, ks, n_live, lane);
    const bool edge = j0 + kTile > lk || (causal && j0 + kTile - 1 > warp_row0);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + col + (e & 1);
        s[n][e] = edge && (j >= lk || (causal && j > row_lo + (e >> 1) * 8)) ? kMasked
                                                                           : s[n][e] * scale2;
      }
    float alpha[2];
    online_softmax<kTile, kPartial>(s, m, l, alpha, n_live);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    tile_pv_f32<DP, kTile, kPartial, 0>(acc, s, ks + kPlane, n_live, lane);
  };

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    // tile t has landed for every thread, and every warp is done with tile
    // t - 1, whose buffer now takes tile t + 1 while tile t is consumed
    __syncthreads();
    if (t + 1 < n_tiles) load_step(t + 1);
    cp_async_commit();
    float* ks = kv + (t & 1) * 2 * kPlane;
    const int j0 = t * kTile;
    const int n_live = min(kTile, warp_keys - j0);
    if (warp_live && n_live == kTile) step(ks, j0, n_live, Flag<false>{});
    else if (warp_live && n_live > 0) step(ks, j0, n_live, Flag<true>{});
  }
  if (!warp_live) return;
  // the lanes' parts of l summed; every row has a live key, so l >= 1
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if constexpr (FLASH) l[0] = fmaxf(l[0], 1e-30f), l[1] = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] /= l[e >> 1];
  store_rows_f32<DP>(o, acc, warp_row0, lq, d, vec, lane);
}

// Launch one of the two kernels over [bh, lq] with 64-row blocks.
template <int DP, typename Kernel>
cudaError_t launch_fwd_tf32(Kernel kernel, const void* q, const void* k, const void* v, void* o,
                            int bh, int lq, int lk, int d, float scale, int causal,
                            cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (kMmaRows + 4 * kTf32Tile) * tf32_stride<DP>();
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  const dim3 grid(bh, (lq + kMmaRows - 1) / kMmaRows);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lq, lk, d, scale, causal, vec);
  return cudaGetLastError();
}

}  // namespace fa
