// Shared device helpers for the hand-written kernels.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace admm {

template <typename T> struct Limits;
template <> struct Limits<float> {
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
};
template <> struct Limits<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
};

// jnp.sign / torch.sign: 0 at 0 (C's copysign would give +-1), NaN stays NaN.
template <typename T> __device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}

// jnp.maximum / torch.maximum: NaN in either operand propagates.
template <typename T> __device__ __forceinline__ T vmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// Fixed-order block sum of one value per thread (blockDim.x a power of two,
// at most 1024): the same inputs give the same bits on every run.
template <typename T> __device__ __forceinline__ T block_sum(T v, T* sh) {
  const int tid = threadIdx.x;
  sh[tid] = v;
  __syncthreads();
  for (int s = blockDim.x >> 1; s > 0; s >>= 1) {
    if (tid < s) sh[tid] = sh[tid] + sh[tid + s];
    __syncthreads();
  }
  T out = sh[0];
  __syncthreads();
  return out;
}

}  // namespace admm
