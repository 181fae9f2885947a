// Masked global max-pool across blocks, shared by K1 and K6: the blocks of
// one cloud combine their tile maxima with atomicMax on an order-preserving
// int encoding of the float. Max is exact in any order, so the result is
// deterministic. pool_init fills the scratch with -inf, pool_decode turns it
// back into floats; a cloud whose points are all masked stays -inf.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

// Signed-int order equals float order (for non-NaN values).
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__global__ void pool_init(int* pooled, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) pooled[i] = ordered(neg_inf());
}

__global__ void pool_decode(const int* pooled, float* out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = unordered(pooled[i]);
}

}  // namespace
