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
// What bounds it on an H100 (published SXM peaks: 495 TFLOP/s TF32 and
// 989 TFLOP/s bf16 on tensor cores, 67 TFLOP/s fp32 FMA, 3.35 TB/s; not
// measured). The work is 10 * pairs * D FLOPs per head (S recomputed, dV,
// dP, dQ, dK) and 8 * L * D elements moved per head (q, k, v, o, dO in; dq,
// dk, dv out); an fp32 FLOP takes three TF32 products (split TF32, below):
//   * training image call [64,12,197,64]: 19.08 GFLOP; in fp32 310 MB moved,
//     operations-bound, ~116 us (3 x 19.08 GFLOP at 495 TFLOP/s; ~285 us on
//     fp32 FMAs); in bf16 155 MB, bytes-bound, ~46 us.
//   * training text call [64,8,77,64] causal: 0.98 GFLOP; in fp32 81 MB,
//     bytes-bound, ~24 us; in bf16 40 MB, bytes-bound, ~12 us.
// Two kernels a call, no atomics, so the result does not depend on launch
// order: the first forms dQ and writes each query row's softmax max m, sum l
// and delta to the `stats` scratch; the second forms dK and dV from them.
// Which pair runs is decided by the shape, and nothing falls back:
//
// bf16 with head_dim <= 128 (every head width of the registry; the training
// path): tensor cores, `fused_attention_bwd_dq_mma_kernel` and
// `fused_attention_bwd_dkdv_mma_kernel`, built from the forwards' blocks in
// attention_mma.cuh (cp.async tiles in rows padded for ldmatrix, mma.sync
// m16n8k16 with fp32 accumulators, 64-row blocks of four warps, each warp 16
// rows). All five products map onto two primitives: `tile_scores` (a warp's
// 16 rows against a tile, A B^T) and `tile_pv` (fp32 accumulators rounded to
// bf16 in registers, round to nearest even as the TPU kernel's `.astype`,
// and used as the A operand against a row-major tile read by ldmatrix.trans).
//   1. dQ: a block owns 64 query rows. K tiles, then K and V tiles, stream
//      through one double-buffered cp.async ring, as in the fused forward.
//      Pass 1 is the forward's pass 1 (online m and l over 64-key tiles, the
//      same arithmetic); delta = rowsum(dO * O) from the stored O; pass 2,
//      16 keys at a time: S = Q K^T and dP = dO V^T on tensor cores,
//      p = exp(s * scale - m) / l and ds = p (dp - delta) in fp32 registers,
//      dQ += ds K (ds rounded to bf16 in tile_pv). Q and dO fragments stay
//      in registers.
//   2. dK/dV: a block owns 64 keys, each warp 16; their K and V rows stay in
//      shared memory and are read as A fragments at each step (registers go
//      to the two DP-wide accumulators, and four blocks an SM at DP = 64
//      outran three with the fragments held in registers).
//      The block walks the 64-row query tiles (from the tile of its first
//      key when causal), Q, dO and the tile's (m, l, delta) double-buffered;
//      per 16 queries: S^T = K Q^T, dP^T = V dO^T, P and dS per element with
//      the statistics of the lane's query columns, dV += P^T dO (P rounded to
//      bf16, the TPU kernel's `p.astype(v.dtype)`), dK += dS^T Q. Masked:
//      queries past Lq (zero-filled, without statistics), col > row.
//   S is computed three times and dP twice; no P or dS tile exists in shared
//   memory. Warps past Lq or Lk compute nothing; the 16-wide groups of a
//   partial chunk past Lq, Lk or the causal edge are skipped in a separate
//   PARTIAL instantiation, so full chunks keep straight-line code.
//   What still holds it back: pass 1 recomputes the statistics the forward
//   already had; at 197 tokens each head's last 64-row block has one live
//   warp of four; exact expf and an fp32 division on every score; mma.sync
//   instead of wgmma; at 128 registers (four blocks an SM) ptxas spills.
//
// float32 with head_dim <= 128 (training at --precision amp or fp32):
// tensor cores too, `fused_attention_bwd_dq_tf32_kernel` and
// `fused_attention_bwd_dkdv_tf32_kernel`, the same design as the bf16 pair
// (blocks, passes, chunks, masks, statistics, no atomics) on the fp32
// building blocks of attention_tf32.cuh: fp32 tiles in rows of DP + 4
// floats, 32-key (dQ) and 32-query (dK/dV) tiles in the cp.async ring, and
// every product from split-TF32 operands, hi + lo, accumulated in fp32 from
// three mma.sync m16n8k8 TF32 products, which keeps fp32 accuracy (within
// 1e-4 of the largest |grad|, like the scalar kernels) whatever
// torch.backends.cuda.matmul.allow_tf32 says. `tile_scores_f32` forms S
// (and dP) exactly as the fp32 forward does, in the same k order and key
// tiles, and the statistics pass is the forward's online pass, so P is the
// forward's function. The products that take an accumulator as A (dS K,
// P^T dO, dS^T Q) read it in a permuted k order, with the B tile's rows read
// in the same order, instead of moving values between lanes. The dQ kernel
// keeps Q's and dO's hi and lo fragments in registers up to DP = 64 (two
// blocks an SM); the dK/dV kernel reads its K and V fragments from shared
// memory at each step. Up to DP = 64 every tile is split once where it lands
// in shared memory, into a hi and a lo plane (the dK/dV kernel's streamed Q
// and dO tiles then hold 16 rows, for shared memory), which ran faster than
// splitting at every fragment read (scripts/tune_attention_bwd.py, PERF.md);
// at DP = 128 the second planes do not fit, and fragments split on read.
// Bound: the larger of 3 x FLOPs at 495 TFLOP/s and the bytes at 3.35 TB/s
// (above). What still holds it back: three m16n8k8 products for each
// product; S computed three times and dP twice, as in bf16; a barrier for
// every 16 streamed queries in the dK/dV kernel; two blocks an SM (the dQ
// kernel's register-held Q and dO fragments take 128 registers); mma.sync
// instead of wgmma.
//
// float32 and bf16 with head_dim > 128 (no registry model has such heads;
// the dK and dV accumulators alone would take 256 registers a thread on a
// tensor-core route): the scalar kernels of the first port,
// `fused_attention_bwd_dq_kernel` and `fused_attention_bwd_dkdv_kernel`, a
// documented route by shape.
//   1. dq: one block owns 32 query rows of one (batch, head). Two passes
//      over 32-key tiles give each row's max m and sum l of the fp32 softmax
//      (each lane sums its own keys, then one warp sum: the forward kernel's
//      order, so P is the forward's P bit for bit); delta comes from O and
//      dO; a third pass forms dS per tile in shared memory and accumulates
//      dQ in registers. It writes m, l and delta to a scratch buffer for the
//      second kernel.
//   2. dkdv: one block owns 32 keys; K and V stay in shared memory while it
//      walks the 32-row query tiles (from the key tile's diagonal when
//      causal), recomputes P from (m, l), forms P-in-T and dS tiles, and
//      accumulates dK and dV in registers.
// Score products are scalar fp32 FMAs from float4 shared-memory reads, as in
// the forward kernel. Shared memory is 4 tiles of 32 x (D+4) floats plus two
// 32 x 33 tiles: 141.6 KB at D = 256, so every shape the gate admits fits.
// S is computed four times and dP twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "attention_mma.cuh"
#include "attention_tf32.cuh"
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

// ---- bf16 on tensor cores, head_dim <= 128 (see the note at the top) ----

using bf16 = __nv_bfloat16;

constexpr int kChunk = 16;  // keys (dQ) or queries (dK/dV) per product step

// blocks an SM should hold: four up to DP = 64 (at most 128 registers a
// thread; ptxas spills a little, and fewer blocks without spills ran slower:
// scripts/tune_attention_bwd.py), two at DP = 128, as shared memory allows
template <int DP>
constexpr int mma_bwd_min_blocks() { return DP <= 64 ? 4 : 2; }

// 4 bytes global -> shared; `live` false writes zeros
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(fa::smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0));
}

template <int DP>
__global__ void __launch_bounds__(fa::kMmaThreads, mma_bwd_min_blocks<DP>())
    fused_attention_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                      const bf16* __restrict__ v, const bf16* __restrict__ o,
                                      const bf16* __restrict__ dout, bf16* __restrict__ dq,
                                      float* __restrict__ stats, int bh_total, int lq, int lk,
                                      int d, float scale, int causal, int vec) {
  constexpr int kRows = fa::kMmaRows;
  constexpr int kTile = fa::mma_key_tile<DP>();
  constexpr int kStride = fa::mma_stride<DP>();
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // [kRows][kStride]
  bf16* dos = qs + kRows * kStride;            // dO rows
  bf16* kv = dos + kRows * kStride;            // two buffers of K then V, [kTile][kStride] each

  size_t bh;
  int q0;
  fa::mma_block_coords((lq + kRows - 1) / kRows, &bh, &q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  q += bh * lq * d;
  o += bh * lq * d;
  dout += bh * lq * d;
  dq += bh * lq * d;
  k += bh * lk * d;
  v += bh * lk * d;

  // when causal, keys past the block's last row are masked for all its rows
  const int n_keys = causal ? min(lk, q0 + kRows) : lk;
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  // step i < n_tiles: pass 1, K tile i; step n_tiles + t: pass 2, K and V tile t
  auto load_step = [&](int i) {
    const int t = i < n_tiles ? i : i - n_tiles;
    bf16* buf = kv + (i & 1) * 2 * kTile * kStride;
    fa::load_tile<DP, kTile>(buf, k, t * kTile, lk, d, vec);
    if (i >= n_tiles) fa::load_tile<DP, kTile>(buf + kTile * kStride, v, t * kTile, lk, d, vec);
  };

  fa::load_tile<DP, kRows>(qs, q, q0, lq, d, vec);
  fa::load_tile<DP, kRows>(dos, dout, q0, lq, d, vec);
  load_step(0);
  fa::cp_async_commit();
  fa::cp_async_wait<0>();
  __syncthreads();

  const bf16* qw = qs + warp * 16 * kStride;  // the warp's 16 rows
  const bf16* dw = dos + warp * 16 * kStride;
  uint32_t qf[DP / 16][4], df[DP / 16][4];
  fa::load_q_frags<DP>(qf, qw, lane);
  fa::load_q_frags<DP>(df, dw, lane);

  // a lane's rows: row_lo (accumulator elements 0, 1) and row_lo + 8 (2, 3)
  const int warp_row0 = q0 + warp * 16;
  const int row_lo = warp_row0 + (lane >> 2);
  const int col = (lane & 3) * 2;
  const bool warp_live = warp_row0 < lq;
  const int warp_keys = causal ? min(lk, warp_row0 + 16) : lk;

  // delta = rowsum(dO * O) in fp32 from the stored O; the four lanes of a
  // row sum every fourth column, then one quad sum
  float delta[2] = {0.f, 0.f};
  if (warp_live) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (row < lq)
        for (int c = lane & 3; c < d; c += 4)
          delta[h] = fmaf(__bfloat162float(dout[(size_t)row * d + c]),
                          __bfloat162float(o[(size_t)row * d + c]), delta[h]);
      delta[h] = fa::quad_sum(delta[h]);
    }
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // Pass 1, one 64-key tile: the fused forward's pass 1 (masked scores -inf,
  // running row max, this lane's part of the row sum).
  auto stats_step = [&](const bf16* ks, int j0, int n_live, auto partial) {
    constexpr bool kPartial = decltype(partial)::value;
    float s[kTile / 8][4];
    fa::tile_scores<DP, kTile, true, kPartial>(s, qf, qw, ks, n_live, lane);
    const bool edge = j0 + kTile > lk || (causal && j0 + kTile - 1 > warp_row0);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + col + (e & 1);
        s[n][e] = edge && (j >= lk || (causal && j > row_lo + (e >> 1) * 8)) ? -INFINITY
                                                                           : s[n][e] * scale;
      }
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
  };

  // Pass 2, a chunk of keys: S and dP, then p and ds in fp32, dQ += ds K. `ks` and
  // `vs` point at the chunk's K and V rows.
  auto grad_step = [&](const bf16* ks, const bf16* vs, int j0, int n_live, auto partial) {
    constexpr bool kPartial = decltype(partial)::value;
    float s[kChunk / 8][4], dp[kChunk / 8][4];
    fa::tile_scores<DP, kChunk, true, kPartial>(s, qf, qw, ks, n_live, lane);
    fa::tile_scores<DP, kChunk, true, kPartial>(dp, df, dw, vs, n_live, lane);
    const bool edge = j0 + kChunk > lk || (causal && j0 + kChunk - 1 > warp_row0);
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + col + (e & 1);
        const int h = e >> 1;
        const bool dead = (kPartial && n * 8 >= n_live) ||
                          (edge && (j >= lk || (causal && j > row_lo + h * 8)));
        const float p = dead ? 0.f : expf(s[n][e] * scale - m[h]) / l[h];
        dp[n][e] = p * (dp[n][e] - delta[h]);
      }
    fa::tile_pv<DP, kChunk, kPartial>(acc, dp, ks, n_live, lane);
  };

  for (int i = 0; i < 2 * n_tiles; ++i) {
    fa::cp_async_wait<0>();
    // step i has landed for every thread, and every warp is done with step
    // i - 1, whose buffer now takes step i + 1 while step i is consumed
    __syncthreads();
    if (i + 1 < 2 * n_tiles) load_step(i + 1);
    fa::cp_async_commit();
    if (!warp_live) continue;
    const bf16* ks = kv + (i & 1) * 2 * kTile * kStride;
    if (i < n_tiles) {
      const int j0 = i * kTile;
      const int n_live = min(kTile, warp_keys - j0);
      if (n_live == kTile) stats_step(ks, j0, n_live, fa::Flag<false>{});
      else if (n_live > 0) stats_step(ks, j0, n_live, fa::Flag<true>{});
      continue;
    }
    if (i == n_tiles) {  // pass 1 is over: the lanes' parts of l summed
      l[0] = fa::quad_sum(l[0]);
      l[1] = fa::quad_sum(l[1]);
    }
    const bf16* vs = ks + kTile * kStride;
#pragma unroll
    for (int c = 0; c < kTile; c += kChunk) {
      const int j0 = (i - n_tiles) * kTile + c;
      const int n_live = min(kChunk, warp_keys - j0);
      if (n_live == kChunk)
        grad_step(ks + c * kStride, vs + c * kStride, j0, n_live, fa::Flag<false>{});
      else if (n_live > 0)
        grad_step(ks + c * kStride, vs + c * kStride, j0, n_live, fa::Flag<true>{});
    }
  }
  if (!warp_live) return;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= scale;
  fa::store_rows<DP>(dq, acc, qs + warp * 16 * kStride, warp_row0, lq, d, vec, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (row >= lq) continue;
      const size_t i = bh * lq + row;
      stats[i] = m[h];
      stats[(size_t)bh_total * lq + i] = l[h];
      stats[2 * (size_t)bh_total * lq + i] = delta[h];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(fa::kMmaThreads, mma_bwd_min_blocks<DP>())
    fused_attention_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v,
                                        const bf16* __restrict__ dout,
                                        const float* __restrict__ stats, bf16* __restrict__ dk,
                                        bf16* __restrict__ dv, int bh_total, int lq, int lk,
                                        int d, float scale, int causal, int vec) {
  constexpr int kRows = fa::kMmaRows;  // keys per block = query rows per tile
  constexpr int kStride = fa::mma_stride<DP>();
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);  // [kRows][kStride], the block's keys
  bf16* vs = ks + kRows * kStride;             // their V rows
  bf16* qd = vs + kRows * kStride;  // two buffers of a Q then a dO tile, [kRows][kStride] each
  float* st = reinterpret_cast<float*>(qd + 4 * kRows * kStride);  // two [3][kRows]: m, l, delta

  size_t bh;
  int j0;
  fa::mma_block_coords((lk + kRows - 1) / kRows, &bh, &j0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  q += bh * lq * d;
  dout += bh * lq * d;
  k += bh * lk * d;
  v += bh * lk * d;
  dk += bh * lk * d;
  dv += bh * lk * d;
  stats += bh * lq;  // m, then l and delta each bh_total * lq further on

  // when causal, queries before the block's first key see none of its keys
  const int first = causal ? j0 : 0;
  const int n_tiles = first < lq ? (lq - first + kRows - 1) / kRows : 0;
  auto load_step = [&](int t) {  // query tile t: its Q and dO rows and statistics
    const int q0 = first + t * kRows;
    bf16* buf = qd + (t & 1) * 2 * kRows * kStride;
    fa::load_tile<DP, kRows>(buf, q, q0, lq, d, vec);
    fa::load_tile<DP, kRows>(buf + kRows * kStride, dout, q0, lq, d, vec);
    float* sb = st + (t & 1) * 3 * kRows;
    for (int i = threadIdx.x; i < 3 * kRows; i += fa::kMmaThreads) {
      const int row = q0 + i % kRows;
      const bool live = row < lq;
      cp_async_4(sb + i, stats + (size_t)(i / kRows) * bh_total * lq + (live ? row : 0), live);
    }
  };

  fa::load_tile<DP, kRows>(ks, k, j0, lk, d, vec);
  fa::load_tile<DP, kRows>(vs, v, j0, lk, d, vec);
  if (n_tiles > 0) load_step(0);
  fa::cp_async_commit();
  fa::cp_async_wait<0>();
  __syncthreads();

  // the warp's 16 keys, read as A fragments from shared memory at each step
  const bf16* kw = ks + warp * 16 * kStride;
  const bf16* vw = vs + warp * 16 * kStride;
  const uint32_t none[1][4] = {};

  // a lane's keys: key_lo (accumulator elements 0, 1) and key_lo + 8 (2, 3);
  // its query columns: n * 8 + col (elements 0, 2) and + 1 (1, 3)
  const int warp_key0 = j0 + warp * 16;
  const int key_lo = warp_key0 + (lane >> 2);
  const int col = (lane & 3) * 2;
  const bool warp_live = warp_key0 < lk;
  float acc_dk[DP / 8][4], acc_dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  // A chunk of queries from i0: S^T and dP^T, then P and dS in fp32, dV += P^T dO,
  // dK += dS^T Q. `qc`, `dc` and `sc` point at the chunk's Q rows, dO rows
  // and statistics (m at sc[0], l at sc[kRows], delta at sc[2 kRows]).
  auto step = [&](const bf16* qc, const bf16* dc, const float* sc, int i0, int n_live,
                  auto partial) {
    constexpr bool kPartial = decltype(partial)::value;
    float s[kChunk / 8][4], dp[kChunk / 8][4];
    fa::tile_scores<DP, kChunk, false, kPartial>(s, none, kw, qc, n_live, lane);
    fa::tile_scores<DP, kChunk, false, kPartial>(dp, none, vw, dc, n_live, lane);
    const bool edge = i0 + kChunk > lq || (causal && warp_key0 + 15 > i0);
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
      const int c = n * 8 + col;
      const float2 mm = *reinterpret_cast<const float2*>(sc + c);
      const float2 ll = *reinterpret_cast<const float2*>(sc + kRows + c);
      const float2 dd = *reinterpret_cast<const float2*>(sc + 2 * kRows + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + c + (e & 1);
        const int key = key_lo + (e >> 1) * 8;
        const bool dead = (kPartial && n * 8 >= n_live) ||
                          (edge && (i >= lq || (causal && key > i)));
        const float p = dead ? 0.f
                             : expf(s[n][e] * scale - ((e & 1) ? mm.y : mm.x)) /
                                   ((e & 1) ? ll.y : ll.x);
        s[n][e] = p;
        dp[n][e] = dead ? 0.f : p * (dp[n][e] - ((e & 1) ? dd.y : dd.x));
      }
    }
    fa::tile_pv<DP, kChunk, kPartial>(acc_dv, s, dc, n_live, lane);
    fa::tile_pv<DP, kChunk, kPartial>(acc_dk, dp, qc, n_live, lane);
  };

  for (int t = 0; t < n_tiles; ++t) {
    fa::cp_async_wait<0>();
    // tile t has landed for every thread, and every warp is done with tile
    // t - 1, whose buffer now takes tile t + 1 while tile t is consumed
    __syncthreads();
    if (t + 1 < n_tiles) load_step(t + 1);
    fa::cp_async_commit();
    if (!warp_live) continue;
    const int q0 = first + t * kRows;
    const bf16* qt = qd + (t & 1) * 2 * kRows * kStride;
    const bf16* dt = qt + kRows * kStride;
    const float* sb = st + (t & 1) * 3 * kRows;
#pragma unroll
    for (int c = 0; c < kRows; c += kChunk) {
      const int i0 = q0 + c;
      const int n_live = min(kChunk, lq - i0);
      // past Lq, or (causal) every query before the warp's first key
      if (n_live <= 0 || (causal && i0 + kChunk - 1 < warp_key0)) continue;
      if (n_live == kChunk)
        step(qt + c * kStride, dt + c * kStride, sb + c, i0, n_live, fa::Flag<false>{});
      else
        step(qt + c * kStride, dt + c * kStride, sb + c, i0, n_live, fa::Flag<true>{});
    }
  }
  if (!warp_live) return;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] *= scale;
  // the warp's own K and V rows stage the stores
  fa::store_rows<DP>(dk, acc_dk, ks + warp * 16 * kStride, warp_key0, lk, d, vec, lane);
  fa::store_rows<DP>(dv, acc_dv, vs + warp * 16 * kStride, warp_key0, lk, d, vec, lane);
}

template <int DP>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr size_t row_bytes = sizeof(bf16) * fa::mma_stride<DP>();
  constexpr size_t smem_dq = (2 * fa::kMmaRows + 4 * fa::mma_key_tile<DP>()) * row_bytes;
  constexpr size_t smem_dkdv = 6 * fa::kMmaRows * row_bytes + 2 * 3 * fa::kMmaRows * sizeof(float);
  auto k1 = fused_attention_bwd_dq_mma_kernel<DP>;
  auto k2 = fused_attention_bwd_dkdv_mma_kernel<DP>;
  cudaError_t err = fa::reserve_smem(k1, smem_dq);
  if (err != cudaSuccess) return err;
  err = fa::reserve_smem(k2, smem_dkdv);
  if (err != cudaSuccess) return err;
  const int vec = a.d % 8 == 0 && fa::aligned16(a.q) && fa::aligned16(a.k) &&
                  fa::aligned16(a.v) && fa::aligned16(a.o) && fa::aligned16(a.dout) &&
                  fa::aligned16(a.dq) && fa::aligned16(a.dk) && fa::aligned16(a.dv);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int rows = fa::kMmaRows;
  k1<<<dim3(a.bh, (a.lq + rows - 1) / rows), fa::kMmaThreads, smem_dq, stream>>>(
      q, k, v, static_cast<const bf16*>(a.o), dout, static_cast<bf16*>(a.dq), a.stats, a.bh,
      a.lq, a.lk, a.d, a.scale, a.causal, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<dim3(a.bh, (a.lk + rows - 1) / rows), fa::kMmaThreads, smem_dkdv, stream>>>(
      q, k, v, dout, a.stats, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.bh, a.lq,
      a.lk, a.d, a.scale, a.causal, vec);
  return cudaGetLastError();
}

// bf16 by head_dim: the tensor-core kernels up to 128, the scalar ones past it
cudaError_t dispatch_bf16(const Args& a, cudaStream_t s) {
  if (a.d <= 32) return launch_mma<32>(a, s);
  if (a.d <= 64) return launch_mma<64>(a, s);
  if (a.d <= 128) return launch_mma<128>(a, s);
  return launch<bf16, 256>(a, s);
}

// ---- fp32 on tensor cores, head_dim <= 128: split-TF32 products (see the note at the top) ----

// blocks an SM, both kernels: with tiles split where they land (DP <= 64)
// shared memory holds two, and the dQ kernel's Q and dO fragments (hi and
// lo) take 128 registers; at DP = 128 the accumulators do. The dK/dV
// kernel capped at 168 registers for three ran slower
// (scripts/tune_attention_bwd.py).
constexpr int kTf32BwdBlocks = 2;
// the dQ kernel's Q and dO fragments held in registers, split once
template <int DP>
__host__ __device__ constexpr bool tf32_dq_regs() { return DP <= 64; }

template <int DP>
__global__ void __launch_bounds__(fa::kMmaThreads, kTf32BwdBlocks)
    fused_attention_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                       const float* __restrict__ v, const float* __restrict__ o,
                                       const float* __restrict__ dout, float* __restrict__ dq,
                                       float* __restrict__ stats, int bh_total, int lq, int lk,
                                       int d, float scale, int causal, int vec) {
  constexpr int kRows = fa::kMmaRows;
  constexpr int kTile = fa::kTf32Tile;
  constexpr int kStride = fa::tf32_stride<DP>();
  constexpr bool kRegs = tf32_dq_regs<DP>();
  constexpr bool kPre = fa::tf32_bwd_presplit<DP>();
  // a K or V tile's lo plane right after it (Q and dO, read once into
  // registers or at DP = 128 split on read, have none)
  constexpr int kLo = kPre ? kTile * kStride : 0;
  constexpr int kPlane = kTile * kStride * (kPre ? 2 : 1);  // one K or V tile, both planes
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][kStride]
  float* dos = qs + kRows * kStride;             // dO rows
  float* kv = qs + 2 * kRows * kStride;         // two buffers of a K then a V tile

  size_t bh;
  int q0;
  fa::mma_block_coords((lq + kRows - 1) / kRows, &bh, &q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  q += bh * lq * d;
  o += bh * lq * d;
  dout += bh * lq * d;
  dq += bh * lq * d;
  k += bh * lk * d;
  v += bh * lk * d;

  // when causal, keys past the block's last row are masked for all its rows
  const int n_keys = causal ? min(lk, q0 + kRows) : lk;
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  // step i < n_tiles: pass 1, K tile i; step n_tiles + t: pass 2, K and V tile t
  auto load_step = [&](int i) {
    const int t = i < n_tiles ? i : i - n_tiles;
    float* buf = kv + (i & 1) * 2 * kPlane;
    fa::load_tile_f32<DP, kTile>(buf, k, t * kTile, lk, d, vec);
    if (i >= n_tiles) fa::load_tile_f32<DP, kTile>(buf + kPlane, v, t * kTile, lk, d, vec);
  };

  fa::load_tile_f32<DP, kRows>(qs, q, q0, lq, d, vec);
  fa::load_tile_f32<DP, kRows>(dos, dout, q0, lq, d, vec);
  load_step(0);
  fa::cp_async_commit();
  fa::cp_async_wait<0>();
  __syncthreads();

  const float* qw = qs + warp * 16 * kStride;  // the warp's 16 rows
  const float* dw = dos + warp * 16 * kStride;
  uint32_t qf[kRegs ? DP / 8 : 1][2][4], df[kRegs ? DP / 8 : 1][2][4];
  if constexpr (kRegs) {
    fa::load_a_frags<DP>(qf, qw, lane);
    fa::load_a_frags<DP>(df, dw, lane);
  }

  // a lane's rows: row_lo (accumulator elements 0, 1) and row_lo + 8 (2, 3)
  const int warp_row0 = q0 + warp * 16;
  const int row_lo = warp_row0 + (lane >> 2);
  const int col = (lane & 3) * 2;
  const bool warp_live = warp_row0 < lq;
  const int warp_keys = causal ? min(lk, warp_row0 + 16) : lk;

  // delta = rowsum(dO * O) in fp32 from the stored O; the four lanes of a
  // row sum every fourth column, then one quad sum
  float delta[2] = {0.f, 0.f};
  if (warp_live) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (row < lq)
        for (int c = lane & 3; c < d; c += 4)
          delta[h] = fmaf(dout[(size_t)row * d + c], o[(size_t)row * d + c], delta[h]);
      delta[h] = fa::quad_sum(delta[h]);
    }
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // Pass 1, one key tile: the fused forward's scores and running statistics,
  // the same arithmetic (so m and l are the forward's; base 2, m in units of
  // the scores times scale * log2(e)).
  const float scale2 = scale * fa::kLog2e;
  auto stats_step = [&](const float* ks, int j0, int n_live, auto partial) {
    constexpr bool kPartial = decltype(partial)::value;
    float s[kTile / 8][4];
    fa::tile_scores_f32<DP, kTile, kRegs, kPartial, 0, kLo>(s, qf, qw, ks, n_live, lane);
    const bool edge = j0 + kTile > lk || (causal && j0 + kTile - 1 > warp_row0);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + col + (e & 1);
        s[n][e] = edge && (j >= lk || (causal && j > row_lo + (e >> 1) * 8)) ? -INFINITY
                                                                           : s[n][e] * scale2;
      }
    float alpha[2];
    fa::online_softmax<kTile, kPartial>(s, m, l, alpha, n_live);
  };

  // Pass 2, a chunk of keys: S and dP, then p and ds in fp32, dQ += ds K.
  // `ks` and `vs` point at the chunk's K and V rows.
  auto grad_step = [&](const float* ks, const float* vs, int j0, int n_live, auto partial) {
    constexpr bool kPartial = decltype(partial)::value;
    float s[kChunk / 8][4], dp[kChunk / 8][4];
    fa::tile_scores_f32<DP, kChunk, kRegs, kPartial, 0, kLo>(s, qf, qw, ks, n_live, lane);
    fa::tile_scores_f32<DP, kChunk, kRegs, kPartial, 0, kLo>(dp, df, dw, vs, n_live, lane);
    const bool edge = j0 + kChunk > lk || (causal && j0 + kChunk - 1 > warp_row0);
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + col + (e & 1);
        const int h = e >> 1;
        const bool dead = (kPartial && n * 8 >= n_live) ||
                          (edge && (j >= lk || (causal && j > row_lo + h * 8)));
        const float p = dead ? 0.f : exp2f(s[n][e] * scale2 - m[h]) * inv_l[h];
        dp[n][e] = p * (dp[n][e] - delta[h]);
      }
    fa::tile_pv_f32<DP, kChunk, kPartial, kLo>(acc, dp, ks, n_live, lane);
  };

  for (int i = 0; i < 2 * n_tiles; ++i) {
    fa::cp_async_wait<0>();
    // step i has landed for every thread, and every warp is done with step
    // i - 1, whose buffer now takes step i + 1 while step i is consumed
    __syncthreads();
    if (i + 1 < 2 * n_tiles) load_step(i + 1);
    fa::cp_async_commit();
    float* ks = kv + (i & 1) * 2 * kPlane;
    if constexpr (kPre) {  // split step i's tiles once, then wait for them
      fa::split_tile<DP, kTile, kLo>(ks);
      if (i >= n_tiles) fa::split_tile<DP, kTile, kLo>(ks + kPlane);
      __syncthreads();
    }
    if (!warp_live) continue;
    if (i < n_tiles) {
      const int j0 = i * kTile;
      const int n_live = min(kTile, warp_keys - j0);
      if (n_live == kTile) stats_step(ks, j0, n_live, fa::Flag<false>{});
      else if (n_live > 0) stats_step(ks, j0, n_live, fa::Flag<true>{});
      continue;
    }
    if (i == n_tiles) {  // pass 1 is over: the lanes' parts of l summed
      inv_l[0] = 1.f / fa::quad_sum(l[0]);
      inv_l[1] = 1.f / fa::quad_sum(l[1]);
    }
    const float* vs = ks + kPlane;
#pragma unroll
    for (int c = 0; c < kTile; c += kChunk) {
      const int j0 = (i - n_tiles) * kTile + c;
      const int n_live = min(kChunk, warp_keys - j0);
      if (n_live == kChunk)
        grad_step(ks + c * kStride, vs + c * kStride, j0, n_live, fa::Flag<false>{});
      else if (n_live > 0)
        grad_step(ks + c * kStride, vs + c * kStride, j0, n_live, fa::Flag<true>{});
    }
  }
  if (!warp_live) return;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= scale;
  fa::store_rows_f32<DP>(dq, acc, warp_row0, lq, d, vec, lane);
  if ((lane & 3) == 0) {  // m in base-2 units and 1 / l, as the dK/dV kernel takes them
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (row >= lq) continue;
      const size_t i = bh * lq + row;
      stats[i] = m[h];
      stats[(size_t)bh_total * lq + i] = inv_l[h];
      stats[2 * (size_t)bh_total * lq + i] = delta[h];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(fa::kMmaThreads, kTf32BwdBlocks)
    fused_attention_bwd_dkdv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const float* __restrict__ dout,
                                         const float* __restrict__ stats, float* __restrict__ dk,
                                         float* __restrict__ dv, int bh_total, int lq, int lk,
                                         int d, float scale, int causal, int vec) {
  constexpr int kKeys = fa::kMmaRows;  // keys per block
  constexpr int kStride = fa::tf32_stride<DP>();
  constexpr bool kPre = fa::tf32_bwd_presplit<DP>();
  // query rows per tile of the stream: half as many when tiles carry lo planes
  constexpr int kQt = kPre ? fa::kTf32Tile / 2 : fa::kTf32Tile;
  // lo planes: the block's K and V after both; a Q or dO tile's right after it
  constexpr int kKLo = kPre ? 2 * kKeys * kStride : 0;
  constexpr int kLo = kPre ? kQt * kStride : 0;
  constexpr int kPlane = kQt * kStride * (kPre ? 2 : 1);  // one Q or dO tile, both planes
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kKeys][kStride], the block's keys
  float* vs = ks + kKeys * kStride;             // their V rows
  float* qd = ks + 2 * kKeys * kStride * (kPre ? 2 : 1);  // two buffers of a Q then a dO tile
  float* st = qd + 4 * kPlane;                  // two [3][kQt]: m, l, delta

  size_t bh;
  int j0;
  fa::mma_block_coords((lk + kKeys - 1) / kKeys, &bh, &j0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  q += bh * lq * d;
  dout += bh * lq * d;
  k += bh * lk * d;
  v += bh * lk * d;
  dk += bh * lk * d;
  dv += bh * lk * d;
  stats += bh * lq;  // m, then l and delta each bh_total * lq further on

  // when causal, queries before the block's first key see none of its keys
  const int first = causal ? j0 : 0;
  const int n_tiles = first < lq ? (lq - first + kQt - 1) / kQt : 0;
  auto load_step = [&](int t) {  // query tile t: its Q and dO rows and statistics
    const int q0 = first + t * kQt;
    float* buf = qd + (t & 1) * 2 * kPlane;
    fa::load_tile_f32<DP, kQt>(buf, q, q0, lq, d, vec);
    fa::load_tile_f32<DP, kQt>(buf + kPlane, dout, q0, lq, d, vec);
    float* sb = st + (t & 1) * 3 * kQt;
    for (int i = threadIdx.x; i < 3 * kQt; i += fa::kMmaThreads) {
      const int row = q0 + i % kQt;
      const bool live = row < lq;
      cp_async_4(sb + i, stats + (size_t)(i / kQt) * bh_total * lq + (live ? row : 0), live);
    }
  };

  fa::load_tile_f32<DP, kKeys>(ks, k, j0, lk, d, vec);
  fa::load_tile_f32<DP, kKeys>(vs, v, j0, lk, d, vec);
  if (n_tiles > 0) load_step(0);
  fa::cp_async_commit();
  fa::cp_async_wait<0>();
  __syncthreads();
  if constexpr (kPre) fa::split_tile<DP, 2 * kKeys, kKLo>(ks);  // the block's K and V, once

  // the warp's 16 keys, read as A fragments from shared memory at each step
  const float* kw = ks + warp * 16 * kStride;
  const float* vw = vs + warp * 16 * kStride;
  const uint32_t none[1][2][4] = {};

  // a lane's keys: key_lo (accumulator elements 0, 1) and key_lo + 8 (2, 3);
  // its query columns: n * 8 + col (elements 0, 2) and + 1 (1, 3)
  const int warp_key0 = j0 + warp * 16;
  const int key_lo = warp_key0 + (lane >> 2);
  const int col = (lane & 3) * 2;
  const bool warp_live = warp_key0 < lk;
  float acc_dk[DP / 8][4], acc_dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  // A chunk of queries from i0: S^T and dP^T, then P and dS in fp32, dV +=
  // P^T dO, dK += dS^T Q. `qc`, `dc` and `sc` point at the chunk's Q rows,
  // dO rows and statistics (m in base-2 units at sc[0], 1 / l at sc[kQt],
  // delta at sc[2 kQt]).
  const float scale2 = scale * fa::kLog2e;
  auto step = [&](const float* qc, const float* dc, const float* sc, int i0, int n_live,
                  auto partial) {
    constexpr bool kPartial = decltype(partial)::value;
    float s[kChunk / 8][4], dp[kChunk / 8][4];
    fa::tile_scores_f32<DP, kChunk, false, kPartial, kKLo, kLo>(s, none, kw, qc, n_live, lane);
    fa::tile_scores_f32<DP, kChunk, false, kPartial, kKLo, kLo>(dp, none, vw, dc, n_live, lane);
    const bool edge = i0 + kChunk > lq || (causal && warp_key0 + 15 > i0);
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
      const int c = n * 8 + col;
      const float2 mm = *reinterpret_cast<const float2*>(sc + c);
      const float2 ll = *reinterpret_cast<const float2*>(sc + kQt + c);
      const float2 dd = *reinterpret_cast<const float2*>(sc + 2 * kQt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + c + (e & 1);
        const int key = key_lo + (e >> 1) * 8;
        const bool dead = (kPartial && n * 8 >= n_live) ||
                          (edge && (i >= lq || (causal && key > i)));
        const float p = dead ? 0.f
                             : exp2f(s[n][e] * scale2 - ((e & 1) ? mm.y : mm.x)) *
                                   ((e & 1) ? ll.y : ll.x);
        s[n][e] = p;
        dp[n][e] = dead ? 0.f : p * (dp[n][e] - ((e & 1) ? dd.y : dd.x));
      }
    }
    fa::tile_pv_f32<DP, kChunk, kPartial, kLo>(acc_dv, s, dc, n_live, lane);
    fa::tile_pv_f32<DP, kChunk, kPartial, kLo>(acc_dk, dp, qc, n_live, lane);
  };

  for (int t = 0; t < n_tiles; ++t) {
    fa::cp_async_wait<0>();
    // tile t has landed for every thread, and every warp is done with tile
    // t - 1, whose buffer now takes tile t + 1 while tile t is consumed
    __syncthreads();
    if (t + 1 < n_tiles) load_step(t + 1);
    fa::cp_async_commit();
    float* qt = qd + (t & 1) * 2 * kPlane;
    float* dt = qt + kPlane;
    if constexpr (kPre) {  // split tile t once, then wait for it
      fa::split_tile<DP, kQt, kLo>(qt);
      fa::split_tile<DP, kQt, kLo>(dt);
      __syncthreads();
    }
    if (!warp_live) continue;
    const int q0 = first + t * kQt;
    const float* sb = st + (t & 1) * 3 * kQt;
#pragma unroll
    for (int c = 0; c < kQt; c += kChunk) {
      const int i0 = q0 + c;
      const int n_live = min(kChunk, lq - i0);
      // past Lq, or (causal) every query before the warp's first key
      if (n_live <= 0 || (causal && i0 + kChunk - 1 < warp_key0)) continue;
      if (n_live == kChunk)
        step(qt + c * kStride, dt + c * kStride, sb + c, i0, n_live, fa::Flag<false>{});
      else
        step(qt + c * kStride, dt + c * kStride, sb + c, i0, n_live, fa::Flag<true>{});
    }
  }
  if (!warp_live) return;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] *= scale;
  fa::store_rows_f32<DP>(dk, acc_dk, warp_key0, lk, d, vec, lane);
  fa::store_rows_f32<DP>(dv, acc_dv, warp_key0, lk, d, vec, lane);
}

template <int DP>
cudaError_t launch_tf32(const Args& a, cudaStream_t stream) {
  constexpr bool kPre = fa::tf32_bwd_presplit<DP>();
  constexpr size_t row_bytes = sizeof(float) * fa::tf32_stride<DP>();
  constexpr int kQt = kPre ? fa::kTf32Tile / 2 : fa::kTf32Tile;
  constexpr int kPlanes = kPre ? 2 : 1;  // hi, and lo when tiles are split where they land
  constexpr size_t smem_dq = (2 * fa::kMmaRows + 4 * fa::kTf32Tile * kPlanes) * row_bytes;
  constexpr size_t smem_dkdv =
      (2 * fa::kMmaRows + 4 * kQt) * kPlanes * row_bytes + 2 * 3 * kQt * sizeof(float);
  auto k1 = fused_attention_bwd_dq_tf32_kernel<DP>;
  auto k2 = fused_attention_bwd_dkdv_tf32_kernel<DP>;
  cudaError_t err = fa::reserve_smem(k1, smem_dq);
  if (err != cudaSuccess) return err;
  err = fa::reserve_smem(k2, smem_dkdv);
  if (err != cudaSuccess) return err;
  const int vec = a.d % 4 == 0 && fa::aligned16(a.q) && fa::aligned16(a.k) &&
                  fa::aligned16(a.v) && fa::aligned16(a.o) && fa::aligned16(a.dout) &&
                  fa::aligned16(a.dq) && fa::aligned16(a.dk) && fa::aligned16(a.dv);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const int rows = fa::kMmaRows;
  k1<<<dim3(a.bh, (a.lq + rows - 1) / rows), fa::kMmaThreads, smem_dq, stream>>>(
      q, k, v, static_cast<const float*>(a.o), dout, static_cast<float*>(a.dq), a.stats, a.bh,
      a.lq, a.lk, a.d, a.scale, a.causal, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<dim3(a.bh, (a.lk + rows - 1) / rows), fa::kMmaThreads, smem_dkdv, stream>>>(
      q, k, v, dout, a.stats, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.bh, a.lq,
      a.lk, a.d, a.scale, a.causal, vec);
  return cudaGetLastError();
}

// fp32 by head_dim: the tensor-core kernels up to 128, the scalar ones past it
cudaError_t dispatch_f32(const Args& a, cudaStream_t s) {
  if (a.d <= 32) return launch_tf32<32>(a, s);
  if (a.d <= 64) return launch_tf32<64>(a, s);
  if (a.d <= 128) return launch_tf32<128>(a, s);
  return launch<float, 256>(a, s);
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
  if (dtype == 0) return dispatch_f32(a, s);
  if (dtype == 1) return dispatch_bf16(a, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* fused_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
