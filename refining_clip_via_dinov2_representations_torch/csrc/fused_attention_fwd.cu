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
//   * serving image call [32,12,197,64] fp32: 3.82 GFLOP, 77.5 MB. On TF32
//     tensor cores with three split products a FLOP (3 x 3.82 GFLOP at 495
//     TFLOP/s) ~23 us, and 77.5 MB at 3.35 TB/s ~23 us: both bounds meet.
//     On the 67 TFLOP/s of plain fp32 FMAs it would be ~57 us.
//   * serving text call [32,8,77,64] causal fp32: ~0.20 GFLOP, 20.2 MB,
//     memory-bound, ~6.0 us.
//   * training image call [64,12,197,64] bf16: 7.6 GFLOP over 77.5 MB,
//     memory-bound, ~23 us at 3.35 TB/s (8 us at the 989 TFLOP/s bf16
//     tensor-core rate).
// Only Q, K, V and O touch device memory: P is never written out. Causal
// blocks stop at their last row's diagonal tile.
//
// bf16, the training path: tensor cores (`fused_attention_fwd_mma_kernel`,
// building blocks in attention_mma.cuh), in two passes over the key tiles,
// because the TPU kernel normalises P in fp32 *before* rounding it to bf16
// for the PV product: a flash-style division after the product computes a
// different function. Pass 1 takes each row's max m and sum l in fp32
// (online, l rescaled as m grows); pass 2 recomputes S and forms
// p = exp(s - m) / l in fp32, rounds it to bf16 and accumulates P V. A block
// of four warps owns 64 query rows of one (batch, head), each warp 16 rows:
// the m16 of mma.sync m16n8k16. Q, K and V stay bf16 in shared memory, in
// rows padded by 16 bytes so ldmatrix reads them without bank conflicts;
// cp.async copies 16 bytes at a time where d % 8 == 0 and the bases are
// aligned (element copies otherwise; d is zero-padded to DP). The tiles of
// both passes form one double-buffered stream (K in pass 1, K and V in pass
// 2): the next tile's copies are in flight while the current one is
// consumed. Both products run on mma.sync with fp32 accumulators; the scale
// multiplies S after the product; S never leaves registers, the row
// statistics are quad shuffles, and p becomes the A operand of P V in
// registers. Shared memory no longer grows with Lk (46,080 bytes at DP = 64,
// 101,376 at DP = 256, 32-key tiles there for the O accumulator's 128
// registers a thread). A warp whose rows all lie past Lq computes nothing,
// and a tile's keys past Lk (or past the warp's last row, when causal) are
// skipped 16 at a time.
// What still holds it back: S is computed twice; exact expf twice and an
// fp32 division on every score; mma.sync instead of wgmma; one
// __syncthreads a tile with four warps a block; at 128 registers (four
// blocks an SM at DP = 64) ptxas spills a few bytes.
//
// fp32 with head_dim <= 128 (serving, and training at --precision amp or
// fp32): tensor cores too (`fused_attention_fwd_tf32_kernel`, a thin wrapper
// over the body in attention_fwd_tf32.cuh, which the flash kernel's fp32
// route shares; building blocks in attention_tf32.cuh), with split-TF32
// products: each fp32 operand is split into two TF32 values, hi + lo, and
// each product is accumulated in fp32 from three mma.sync m16n8k8 TF32
// products (lo hi, hi lo, hi hi). That keeps fp32 accuracy (within 1e-4 of
// the plain version, like the scalar kernel; one TF32 product misses that),
// whatever torch.backends.cuda.matmul.allow_tf32 says. One pass: in fp32 the
// TPU kernel's cast of P to V's dtype is the identity, so an online softmax
// that divides after P V computes the same function up to fp32 rounding, and
// S is computed once (the two-pass rule above is bf16's). The block is the
// bf16 kernel's: 64 query rows, four warps of 16, K and V in 32-key tiles of
// one double-buffered cp.async stream, in fp32 rows of DP + 4 floats (one
// pad serves ldmatrix and the column reads; see attention_tf32.cuh). Q's hi
// and lo fragments stay in registers up to DP = 64 (from shared memory at
// 128). P never leaves registers: an S accumulator becomes the A operand of
// P V in a permuted k order, with V's rows read in the same order. Every
// operand is split where it is read (a tile four warps read is split four
// times): splitting once where a tile lands, at the cost of a barrier and a
// second plane, ran slower here (PERF.md), though it wins in the backward.
// Bound: the larger of 3 x FLOPs at 495 TFLOP/s and the bytes at 3.35 TB/s
// (above). What still holds it back: three m16n8k8 products for each
// product, so six mma.sync instructions for one bf16 m16n8k16's work; the
// split's integer operations on every K and V fragment read; mma.sync
// instead of wgmma; at 197 tokens each head's last 64-row block has one live
// warp of four.
//
// fp32 with head_dim > 128 (no registry model has such heads): the first
// port's scalar kernel, a documented route by shape; the tensor-core route
// stops at 128 as the bf16 backward's does (at DP = 256 the O accumulator
// alone takes 128 registers a thread, and split fragments double the
// operand registers). One
// block owns 32 query rows and keeps their whole fp32 score row (<= 1024
// columns) in shared memory; K and V are staged in 64-key tiles; a lane
// computes 8x2 scores per K tile from float4 shared-memory reads and owns
// D/32 output columns of its warp's 8 rows in the PV product.

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

// The bf16 tensor-core kernel; see the note at the top. `vec`: 16-byte
// copies (d % 8 == 0, aligned bases) instead of element copies.
template <int DP>
__global__ void __launch_bounds__(fa::kMmaThreads, fa::mma_min_blocks<DP>())
    fused_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
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
  // step i < n_tiles: pass 1, K tile i; step n_tiles + t: pass 2, K and V tile t
  auto load_step = [&](int i) {
    const int t = i < n_tiles ? i : i - n_tiles;
    __nv_bfloat16* buf = kv + (i & 1) * 2 * kTile * kStride;
    fa::load_tile<DP, kTile>(buf, k, t * kTile, lk, d, vec);
    if (i >= n_tiles) fa::load_tile<DP, kTile>(buf + kTile * kStride, v, t * kTile, lk, d, vec);
  };

  fa::load_tile<DP, kRows>(qs, q, q0, lq, d, vec);
  load_step(0);
  fa::cp_async_commit();
  fa::cp_async_wait<0>();
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
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // One step: S = Q K^T * scale on tensor cores, masked entries (padding,
  // col > row) -inf; then pass 1's running max and sum, or pass 2's
  // normalised p and acc += P V. PARTIAL: keys from n_live on are not
  // computed (a separate instantiation, so full tiles keep straight-line code).
  auto step = [&](const __nv_bfloat16* ks, int j0, int n_live, bool second, auto partial) {
    constexpr bool kPartial = decltype(partial)::value;
    float s[kTile / 8][4];
    fa::tile_scores<DP, kTile, kQRegs, kPartial>(s, qf, qw, ks, n_live, lane);
    const bool edge = j0 + kTile > lk || (causal && j0 + kTile - 1 > warp_row0);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + col + (e & 1);
        s[n][e] = edge && (j >= lk || (causal && j > row_lo + (e >> 1) * 8)) ? -INFINITY
                                                                           : s[n][e] * scale;
      }

    if (!second) {
      // pass 1: running row max and this lane's part of the row sum
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[h];
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
        mx = fa::quad_max(mx);  // finite from the first tile on: key 0 is live for every row
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n)
          if (!kPartial || n * 8 < n_live)
            sum += expf(s[n][2 * h] - mx) + expf(s[n][2 * h + 1] - mx);
        l[h] = l[h] * expf(m[h] - mx) + sum;
        m[h] = mx;
      }
    } else {
      // pass 2: the normalised softmax in fp32, rounded to bf16 in tile_pv
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = !kPartial || n * 8 < n_live ? expf(s[n][e] - m[e >> 1]) / l[e >> 1] : 0.f;
      fa::tile_pv<DP, kTile, kPartial>(acc, s, ks + kTile * kStride, n_live, lane);
    }
  };

  for (int i = 0; i < 2 * n_tiles; ++i) {
    fa::cp_async_wait<0>();
    // step i has landed for every thread, and every warp is done with step
    // i - 1, whose buffer now takes step i + 1 while step i is consumed
    __syncthreads();
    if (i + 1 < 2 * n_tiles) load_step(i + 1);
    fa::cp_async_commit();
    const bool second = i >= n_tiles;
    const int j0 = (second ? i - n_tiles : i) * kTile;
    const int n_live = min(kTile, warp_keys - j0);
    if (warp_live && i == n_tiles) {  // pass 1 is over: the lanes' parts of l summed
      l[0] = fa::quad_sum(l[0]);
      l[1] = fa::quad_sum(l[1]);
    }
    const __nv_bfloat16* ks = kv + (i & 1) * 2 * kTile * kStride;
    if (warp_live && n_live == kTile) step(ks, j0, n_live, second, fa::Flag<false>{});
    else if (warp_live && n_live > 0) step(ks, j0, n_live, second, fa::Flag<true>{});
  }
  if (warp_live)
    fa::store_rows<DP>(o, acc, qs + warp * 16 * kStride, warp_row0, lq, d, vec, lane);
}

// The fp32 tensor-core kernel (split-TF32 products); its body, shared with
// the flash kernel's fp32 route, is in attention_fwd_tf32.cuh.
template <int DP>
__global__ void __launch_bounds__(fa::kMmaThreads, (fa::tf32_min_blocks<DP, false>()))
    fused_attention_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, float* __restrict__ o, int lq,
                                    int lk, int d, float scale, int causal, int vec) {
  fa::attention_fwd_tf32<DP, false>(q, k, v, o, lq, lk, d, scale, causal, vec);
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

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int bh, int lq,
                       int lk, int d, float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
                      (size_t)(fa::kMmaRows + 4 * fa::mma_key_tile<DP>()) * fa::mma_stride<DP>();
  auto kernel = fused_attention_fwd_mma_kernel<DP>;
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

// fp32 by head_dim: the tensor-core kernel up to 128; past it (no registry
// model has such heads) the scalar kernel, whose O accumulator fits
cudaError_t dispatch_tf32(const void* q, const void* k, const void* v, void* o, int bh, int lq,
                          int lk, int d, float scale, int causal, cudaStream_t s) {
  if (d <= 32)
    return fa::launch_fwd_tf32<32>(fused_attention_fwd_tf32_kernel<32>, q, k, v, o, bh, lq, lk, d,
                                   scale, causal, s);
  if (d <= 64)
    return fa::launch_fwd_tf32<64>(fused_attention_fwd_tf32_kernel<64>, q, k, v, o, bh, lq, lk, d,
                                   scale, causal, s);
  if (d <= 128)
    return fa::launch_fwd_tf32<128>(fused_attention_fwd_tf32_kernel<128>, q, k, v, o, bh, lq, lk,
                                    d, scale, causal, s);
  return launch<float, 256>(q, k, v, o, bh, lq, lk, d, scale, causal, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int fused_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int bh, int lq, int lk, int d, float scale, int causal,
                                   int dtype, void* stream) {
  if (bh <= 0 || lq <= 0 || lk <= 0 || lq > 1024 || lk > 1024 || d <= 0 || d > 256)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_tf32(q, k, v, o, bh, lq, lk, d, scale, causal, s);
  if (dtype == 1) return dispatch_mma(q, k, v, o, bh, lq, lk, d, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* fused_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
