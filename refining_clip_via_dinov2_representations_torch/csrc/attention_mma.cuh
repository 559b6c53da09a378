// bf16 tensor-core building blocks shared by the two forward attention
// kernels: cp.async tile staging, ldmatrix and mma.sync m16n8k16 wrappers,
// and the per-warp products of a 64-row query block.
//
// Layout. A block owns 64 query rows; warp w owns rows 16w..16w+15, the m16
// of the fragment. Tiles live in shared memory as bf16 rows of DP + 8
// elements: the 16-byte pad puts the 8 rows an ldmatrix reads in 8
// different 16-byte bank groups, so its reads have no bank conflicts. Lane l
// holds, of a 16 x 8 fp32 accumulator, rows g = l / 4 and g + 8, columns
// 2 (l % 4) and 2 (l % 4) + 1 (elements 0, 1 and 2, 3).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace fa {

constexpr int kMmaRows = 64;     // query rows per block: 4 warps x m16
constexpr int kMmaThreads = 128;

// keys per K/V tile: at DP = 256 the O accumulator alone is 128 fp32
// registers a thread, so the score tile halves to stay clear of spills
template <int DP>
__host__ __device__ constexpr int mma_key_tile() { return DP >= 256 ? 32 : 64; }

template <int DP>
__host__ __device__ constexpr int mma_stride() { return DP + 8; }

// blocks an SM should hold: up to DP = 64 four, i.e. at most 128 registers
// a thread (the fused kernel then spills a few bytes, and still runs faster
// than at three blocks); wider tiles take what they need
template <int DP>
__host__ __device__ constexpr int mma_min_blocks() { return DP <= 64 ? 4 : 1; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `live` false writes 16 zeros
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to nearest-even bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// reductions over the 4 lanes that share a row of an accumulator
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stage rows [r0, r0 + ROWS) of a [len, d] bf16 matrix into a [ROWS][DP + 8]
// tile, zero past `len` rows and `d` columns. `vec` (d % 8 == 0 and a
// 16-byte aligned base) issues cp.async 16-byte copies, which the caller
// commits and waits for; otherwise the block copies element by element.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int len, int d, bool vec) {
  constexpr int kStride = mma_stride<DP>();
  if (vec) {
    constexpr int kChunks = DP / 8;
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * kChunks; i += kMmaThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool live = r0 + r < len && c < d;
      cp_async_16(dst + r * kStride + c, live ? src + (size_t)(r0 + r) * d + c : src, live);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += kMmaThreads) {
      const int r = i / DP, c = i % DP;
      dst[r * kStride + c] = (r0 + r < len && c < d) ? src[(size_t)(r0 + r) * d + c]
                                                     : __float2bfloat16(0.f);
    }
  }
}

// The warp's Q fragments for the DP / 16 k-steps of a product, from its 16
// rows of the Q tile.
template <int DP>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[DP / 16][4],
                                             const __nv_bfloat16* qw, int lane) {
  constexpr int kStride = mma_stride<DP>();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldmatrix_x4(qf[kk], qw + (lane & 15) * kStride + kk * 16 + (lane >> 4) * 8);
}

// s = (the warp's 16 Q rows) K^T over a BK-key tile, fp32 accumulation.
// Q fragments come from registers (`qf`) when Q_REGS, else from shared
// memory (`qw`, the warp's first Q row) one k-step at a time. In a PARTIAL
// tile, keys from `n_live` on (padding, or causal-masked for every row of
// the warp) are not computed: their scores stay 0 for the caller to mask.
template <int DP, int BK, bool Q_REGS, bool PARTIAL>
__device__ __forceinline__ void tile_scores(float (&s)[BK / 8][4],
                                            const uint32_t (&qf)[Q_REGS ? DP / 16 : 1][4],
                                            const __nv_bfloat16* qw,
                                            const __nv_bfloat16* ks, int n_live, int lane) {
  constexpr int kStride = mma_stride<DP>();
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  // lanes 0-7 address rows of b0 of the even n-tile, 8-15 its b1, 16-31 the odd n-tile's
  const __nv_bfloat16* kl = ks + ((lane & 7) + ((lane >> 4) << 3)) * kStride + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    if constexpr (Q_REGS) {
      a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2], a[3] = qf[kk][3];
    } else {
      ldmatrix_x4(a, qw + (lane & 15) * kStride + kk * 16 + (lane >> 4) * 8);
    }
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      if (PARTIAL && np * 16 >= n_live) break;
      uint32_t b[4];
      ldmatrix_x4(b, kl + np * 16 * kStride + kk * 16);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// o += P V over a BK-key tile. P is the warp's 16 x BK probabilities as
// fp32 accumulators; each is rounded to bf16 here, in registers, repacked
// from the accumulator layout into A fragments (no shared-memory P tile).
// In a PARTIAL tile P is 0 from key `n_live` on, and those k-steps are
// skipped.
template <int DP, int BK, bool PARTIAL>
__device__ __forceinline__ void tile_pv(float (&o)[DP / 8][4], const float (&p)[BK / 8][4],
                                        const __nv_bfloat16* vs, int n_live, int lane) {
  constexpr int kStride = mma_stride<DP>();
  const __nv_bfloat16* vl = vs + (lane & 15) * kStride + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    if (PARTIAL && kk * 16 >= n_live) break;
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vl + kk * 16 * kStride + np * 16);
      mma_bf16(o[2 * np], a, b[0], b[1]);
      mma_bf16(o[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Store the warp's 16 output rows (o already final, in fp32) as bf16: the
// accumulators go through the warp's own rows of a shared tile `stage`
// (free by now) so the global stores are whole 16-byte rows where `vec`.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           const float (&o)[DP / 8][4],
                                           __nv_bfloat16* stage, int row0, int lq, int d,
                                           bool vec, int lane) {
  constexpr int kStride = mma_stride<DP>();
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * kStride + n * 8 + c2) = pack_bf16(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kStride + n * 8 + c2) =
        pack_bf16(o[n][2], o[n][3]);
  }
  __syncwarp();
  if (vec) {
    constexpr int kChunks = DP / 8;
    for (int i = lane; i < 16 * kChunks; i += 32) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      if (row0 + r < lq && c < d)
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * d + c) =
            *reinterpret_cast<const uint4*>(stage + r * kStride + c);
    }
  } else {
    for (int i = lane; i < 16 * DP; i += 32) {
      const int r = i / DP, c = i % DP;
      if (row0 + r < lq && c < d) out[(size_t)(row0 + r) * d + c] = stage[r * kStride + c];
    }
  }
}

// The block's (batch*head, 64-row query tile). The launch grid is
// (B*H, query tiles) as for the fp32 kernels; walking it in launch order
// with the query tiles fastest lets the tiles of one head run together and
// share its K and V in L2.
__device__ __forceinline__ void mma_block_coords(int n_qtiles, size_t* bh, int* q0) {
  const size_t linear = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  *bh = linear / n_qtiles;
  *q0 = (int)(linear % n_qtiles) * kMmaRows;
}

// A compile-time flag for generic lambdas: `f(Flag<true>{})`.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace fa
