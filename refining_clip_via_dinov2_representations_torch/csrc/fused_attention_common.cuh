// Helpers shared by the fused-attention forward and backward kernels:
// dtype conversion with the TPU kernel's rounding, warp reductions, and the
// staging of a row tile into padded fp32 shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace fa {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's astype
}

// The value x takes once cast to T (`x.astype(T)` followed by an fp32 product).
template <typename T>
__device__ __forceinline__ float round_like(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [r0, r0 + rows) of a [len, d] matrix into a [rows][DP + 4] fp32
// tile with NT threads, zero past `len` rows and `d` columns (so padded rows
// and columns add nothing to a product).
template <typename T, int DP, int NT>
__device__ __forceinline__ void stage_tile(float* dst, const T* __restrict__ src, int r0,
                                           int rows, int len, int d) {
  constexpr int kStride = DP + 4;
  for (int i = threadIdx.x; i < rows * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (r0 + r < len && c < d) x = to_float(src[(size_t)(r0 + r) * d + c]);
    dst[r * kStride + c] = x;
  }
}

// Opt a kernel into `smem` bytes of dynamic shared memory, or report that the
// device cannot give them.
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace fa
