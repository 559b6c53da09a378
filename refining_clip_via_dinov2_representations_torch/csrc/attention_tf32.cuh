// fp32 tensor-core building blocks of the fused-attention kernels: split-TF32
// ("3xTF32") products on mma.sync m16n8k8 that keep fp32 accuracy, fp32 tile
// staging by cp.async, and the per-warp products of a 64-row block. The
// fp32 counterparts of attention_mma.cuh's bf16 primitives.
//
// The split. Each fp32 operand is x = hi + lo with hi = cvt.rna.tf32(x) and
// lo = cvt.rna.tf32(x - hi); a product a b accumulates in fp32 as
// a_lo b_hi + a_hi b_lo + a_hi b_hi (the small terms first). What is left
// out (a_lo b_lo, and lo's own rounding) is near 2^-22 of each product,
// close to fp32's 2^-24, where one TF32 product (2^-11 an operand) misses
// the fp32 kernels' 1e-4 contract (tests/test_torch_tf32x3.py). Three
// products at the H100's 495 TFLOP/s of dense TF32 make 165 TFLOP/s of
// fp32-accurate work, against 67 TFLOP/s of fp32 FMAs. The kernels split
// every product whatever torch.backends.cuda.matmul.allow_tf32 says: they
// never read it.
//
// Fragments (PTX ISA, mma.m16n8k8 with .tf32), lane l, g = l / 4, t = l % 4:
//   A 16 x 8, row: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B 8 x 8, col:  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C 16 x 8:      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// So an accumulator is not an A fragment: its lane holds columns 2t and
// 2t + 1, an A fragment columns t and t + 4 (with bf16 m16n8k16 the two
// layouts agree). The products that take an accumulator as A (P V, dS K,
// P^T dO, dS^T Q) permute their k index instead of moving values between
// lanes: in each 8-deep k-step, slot t is key (or query) 2t and slot t + 4
// is 2t + 1, so a = (c0, c2, c1, c3), and the B operand reads its rows in
// the same order, b0 = Y[2t][g], b1 = Y[2t + 1][g]. Permuting the k of both
// factors leaves the sum over k as it is. The score tiles keep their keys
// in natural order, so masks and statistics need no change.
//
// Shared memory. Every tile holds fp32 rows of DP + 4 floats; one pad serves
// both read patterns. Row reads, element (row g, col t) — A of Q, K, V, dO
// and B of K^T, V^T, Q^T, dO^T — go through ldmatrix (b16, x4: an 8 x 4 fp32
// tile a matrix, a 16-byte row an address); the pad puts 8 rows 4 banks
// apart, so the 8 rows of a matrix touch 32 different banks. Column reads,
// element (row 2t, col g) — B of the permuted products — are scalar; at a
// stride of DP + 4 the rows 2t lie 8t banks apart, so banks 8t + g are 32
// different ones too. (Rows in natural order, element (row t, col g), would
// need a stride of DP + 8 for that: the permutation is what lets one pad do.)
//
// Where the split happens: on read, every fragment read splits in registers
// (a tile that four warps read is split four times): the forward, which ran
// faster so; or (`tf32_bwd_presplit`, the backward up to DP = 64, faster so)
// once where a tile lands in shared memory, into a hi plane and a lo plane
// `LO` floats further on, at the cost of the second plane and a barrier.
// The primitives take LO as a template argument, 0 for a split on read.
// scripts/tune_attention_bwd.py builds and times both in the backward.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace fa {

// log2(e): the fp32 kernels' softmax runs in base 2 (exp2 on the scores
// times scale * log2(e)), one multiply and one MUFU.EX2 a score
constexpr float kLog2e = 1.4426950408889634f;

// keys per K/V tile of the fp32 kernels (and query rows per tile of the
// dK/dV kernel's stream): a 64-row tile would double the shared memory
// that four warps wait on at each barrier
constexpr int kTf32Tile = 32;

template <int DP>
__host__ __device__ constexpr int tf32_stride() { return DP + 4; }

// the backward's kernels split each tile once where it lands (see the note
// at the top) up to DP = 64; at DP = 128 the second planes do not fit
template <int DP>
__host__ __device__ constexpr bool tf32_bwd_presplit() { return DP <= 64; }

// x rounded to TF32, nearest with ties away from zero: cvt.rna.tf32.f32 for
// every finite x, in two integer operations (on the sign-magnitude bits,
// adding half of the 13 dropped bits' range raises the magnitude whatever
// the sign; clearing them truncates)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 values in fp32 containers
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// four fp32 values held as raw bits in x[0] become x[0] = hi, x[1] = lo
__device__ __forceinline__ void split4(uint32_t (&x)[2][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[0][i]), x[0][i], x[1][i]);
}

// c += a b: a 16 x 8 tf32 (row), b 8 x 8 tf32 (col), c 16 x 8 fp32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b with fp32 accuracy: a = (hi, lo) fragments, b = (bh0, bh1) hi and
// (bl0, bl1) lo; three products, the small ones first
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const uint32_t (&a)[2][4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, a[1], bh0, bh1);
  mma_tf32(c, a[0], bl0, bl1);
  mma_tf32(c, a[0], bh0, bh1);
}

// Row-read fragments by ldmatrix.x4 at the lane's row address `p` of a hi
// plane, with the lo plane LO floats on, or (LO == 0) split in registers.
template <int LO>
__device__ __forceinline__ void ld_rows(uint32_t (&x)[2][4], const float* p) {
  ldmatrix_x4(x[0], p);
  if constexpr (LO != 0) ldmatrix_x4(x[1], p + LO);
  else split4(x);
}

// Column-read B fragment of the permuted products: b0 = Y[2t][g], b1 =
// Y[2t + 1][g], at the lane's address p = Y + 2t * S + g; b[0] hi, b[1] lo.
template <int S, int LO>
__device__ __forceinline__ void ld_cols(uint32_t (&b)[2][2], const float* p) {
  if constexpr (LO != 0) {
    b[0][0] = __float_as_uint(p[0]), b[0][1] = __float_as_uint(p[S]);
    b[1][0] = __float_as_uint(p[LO]), b[1][1] = __float_as_uint(p[LO + S]);
  } else {
    split_tf32(p[0], b[0][0], b[1][0]);
    split_tf32(p[S], b[0][1], b[1][1]);
  }
}

// The A fragment of an accumulator n-tile in the permuted k order: (c0, c2, c1, c3)
__device__ __forceinline__ void acc_as_a(uint32_t (&a)[2][4], const float (&c)[4]) {
  split_tf32(c[0], a[0][0], a[1][0]);
  split_tf32(c[2], a[0][1], a[1][1]);
  split_tf32(c[1], a[0][2], a[1][2]);
  split_tf32(c[3], a[0][3], a[1][3]);
}

// Stage rows [r0, r0 + ROWS) of a [len, d] fp32 matrix into a [ROWS][DP + 4]
// tile, zero past `len` rows and `d` columns. `vec` (d % 4 == 0 and a 16-byte
// aligned base) issues cp.async 16-byte copies, which the caller commits and
// waits for; otherwise the block copies element by element.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int r0, int len, int d,
                                              bool vec) {
  constexpr int kStride = tf32_stride<DP>();
  if (vec) {
    constexpr int kChunks = DP / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * kChunks; i += kMmaThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const bool live = r0 + r < len && c < d;
      cp_async_16(dst + r * kStride + c, live ? src + (size_t)(r0 + r) * d + c : src, live);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += kMmaThreads) {
      const int r = i / DP, c = i % DP;
      dst[r * kStride + c] = (r0 + r < len && c < d) ? src[(size_t)(r0 + r) * d + c] : 0.f;
    }
  }
}

// Split a landed [ROWS][DP + 4] tile in place: hi stays, lo goes LO floats on.
// The caller holds a barrier before the first read.
template <int DP, int ROWS, int LO>
__device__ __forceinline__ void split_tile(float* tile) {
  constexpr int kStride = tf32_stride<DP>();
  constexpr int kChunks = DP / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kMmaThreads) {
    float4* p = reinterpret_cast<float4*>(tile + (i / kChunks) * kStride + (i % kChunks) * 4);
    const float4 x = *p;
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    *p = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                     __uint_as_float(h[3]));
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(p) + LO) =
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                    __uint_as_float(l[3]));
  }
}

// The warp's A fragments (hi, lo) for the DP / 8 k-steps of a product, from
// its 16 rows `xw` of a tile, split in registers once.
template <int DP>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[DP / 8][2][4], const float* xw,
                                             int lane) {
  constexpr int kStride = tf32_stride<DP>();
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk)
    ld_rows<0>(f[kk], xw + (lane & 15) * kStride + kk * 8 + (lane >> 4) * 4);
}

// s = (the warp's 16 rows of X) Y^T over a BK-row tile `ys` of Y, with fp32
// accuracy. X's fragments come from registers (`xf`) when X_REGS, else from
// shared memory (`xw`, the warp's first row; lo plane XLO on). Y's lo plane
// is YLO floats on. In a PARTIAL tile, rows of Y from `n_live` on (16 at a
// time; padding, or causal-masked for every row of the warp) are not
// computed: their scores stay 0 for the caller to mask.
template <int DP, int BK, bool X_REGS, bool PARTIAL, int XLO, int YLO>
__device__ __forceinline__ void tile_scores_f32(float (&s)[BK / 8][4],
                                                const uint32_t (&xf)[X_REGS ? DP / 8 : 1][2][4],
                                                const float* xw, const float* ys, int n_live,
                                                int lane) {
  constexpr int kStride = tf32_stride<DP>();
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  // lanes 0-7 address rows of b0 of the even n-tile, 8-15 its b1, 16-31 the odd n-tile's
  const float* yl = ys + ((lane & 7) + ((lane >> 4) << 3)) * kStride + ((lane >> 3) & 1) * 4;
  const float* xl = xw + (lane & 15) * kStride + (lane >> 4) * 4;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t a[2][4];
    if constexpr (X_REGS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[0][i] = xf[kk][0][i], a[1][i] = xf[kk][1][i];
    } else {
      ld_rows<XLO>(a, xl + kk * 8);
    }
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      if (PARTIAL && np * 16 >= n_live) break;
      uint32_t b[2][4];
      ld_rows<YLO>(b, yl + np * 16 * kStride + kk * 8);
      mma_tf32x3(s[2 * np], a, b[0][0], b[0][1], b[1][0], b[1][1]);
      mma_tf32x3(s[2 * np + 1], a, b[0][2], b[0][3], b[1][2], b[1][3]);
    }
  }
}

// o += P Y over a BK-row tile `ys` of row-major Y (its rows are the k of the
// product), with fp32 accuracy. P is the warp's 16 x BK fp32 accumulators,
// taken as A fragments in the permuted k order (see the note at the top), and
// Y's rows are read in the same order; Y's lo plane is YLO floats on. In a
// PARTIAL tile P is 0 from `n_live` on, and those k-steps are skipped.
template <int DP, int BK, bool PARTIAL, int YLO>
__device__ __forceinline__ void tile_pv_f32(float (&o)[DP / 8][4], const float (&p)[BK / 8][4],
                                            const float* ys, int n_live, int lane) {
  constexpr int kStride = tf32_stride<DP>();
  const float* yl = ys + 2 * (lane & 3) * kStride + (lane >> 2);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    if (PARTIAL && kk * 8 >= n_live) break;
    uint32_t a[2][4];
    acc_as_a(a, p[kk]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      uint32_t b[2][2];
      ld_cols<kStride, YLO>(b, yl + kk * 8 * kStride + n * 8);
      mma_tf32x3(o[n], a, b[0][0], b[0][1], b[1][0], b[1][1]);
    }
  }
}

// One tile of the online softmax statistics, the same arithmetic in the
// forward and in the backward's statistics pass, in base 2: `s` holds the
// scores times scale * log2(e) (masked -inf) and becomes p = 2^(s - m_new)
// in place (= e^(S scale - M)); m (in the same base-2 units) and the lane's
// part of l are updated; alpha = 2^(m_old - m_new) per row half (0 on the
// first tile). In a PARTIAL tile p is 0 from `n_live` on.
template <int BK, bool PARTIAL>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 8][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int n_live) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
    mx = quad_max(mx);  // finite from the first tile on: key 0 is live for every row
    alpha[h] = exp2f(m[h] - mx);
    m[h] = mx;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = !PARTIAL || n * 8 < n_live ? exp2f(s[n][e] - m[e >> 1]) : 0.f;
      s[n][e] = p;
      sum[e >> 1] += p;
    }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// Store the warp's 16 rows of o (final, fp32) into rows row0.. of `out`:
// float2 stores where `vec` (d % 4 == 0 and aligned bases), else scalar.
template <int DP>
__device__ __forceinline__ void store_rows_f32(float* __restrict__ out, const float (&o)[DP / 8][4],
                                               int row0, int lq, int d, bool vec, int lane) {
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + (lane >> 2) + 8 * h;
    if (row >= lq) continue;
    float* dst = out + (size_t)row * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + c2;
      if (vec) {
        if (c < d) *reinterpret_cast<float2*>(dst + c) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
      } else {
        if (c < d) dst[c] = o[n][2 * h];
        if (c + 1 < d) dst[c + 1] = o[n][2 * h + 1];
      }
    }
  }
}

}  // namespace fa
