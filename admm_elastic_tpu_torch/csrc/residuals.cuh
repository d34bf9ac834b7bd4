// The per-ADMM-iteration residuals of the whole-timestep windows
// (banded_step.cu, cloth_step.cu) and of the sharded stepper's local phase
// (banded_local.cu): how the per-element and per-vertex pieces are summed.
//
// Replaces the residual accumulators of admm_elastic_tpu/ops/pallas/
// banded_step.py (racc, :270-275, 516-520, 904-915), cloth_step.py (:219-
// 221, 438, 607-612) and banded_local.py (:148, 231, 300-304), which add
// into one scalar as the grid walks its chunks.
//
// Here the sums are in a fixed order, without atomics, so a run repeats
// its bits and the plain twins (ops/kernels/residuals.py) repeat them too:
// each block of THREADS elements (vertices) sums its threads' pieces by
// block_sum's halving tree and writes one partial; once a timestep,
// finalize_kernel, one block, sums an ADMM iteration's partials: thread t
// adds partials t, t + THREADS, ... in turn, then the halving tree.
#pragma once

#include "common.cuh"

namespace admm {
namespace residuals {

// The compile-time modes of the kernels that collect.
enum Collect { NONE = 0, PRIMAL = 1, FULL = 2 };

constexpr int THREADS = 128;

// One block's partial of one value a thread, written to *out by thread 0.
// Every thread of the block takes part (blockDim.x = THREADS).
template <typename T>
__device__ __forceinline__ void block_partial(T v, T* out) {
  __shared__ T sh[THREADS];
  const T tot = block_sum(v, sh);
  if (threadIdx.x == 0) *out = tot;
}

// The sum of `count` partials in the fixed order above (every thread of
// the block calls it).
template <typename T>
__device__ __forceinline__ T sum_partials(const T* p, int count, T* sh) {
  T acc = T(0);
  for (int j = threadIdx.x; j < count; j += blockDim.x) acc = acc + p[j];
  return block_sum(acc, sh);
}

// One block of THREADS: for each of `iters` ADMM iterations, the primal
// residual sqrt(sum of its `stride` partials) into res_p[it] (raw: the sum
// itself) and, with dpart, the dual residual dt2 sqrt(sum of its `dstride`
// partials) into res_d[it]. A scenario sweep launches one block a
// scenario: block s reads its partials part_scen (dpart_scen) further on
// and writes its residuals res_scen further on.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    finalize_kernel(const T* part, int stride, const T* dpart, int dstride,
                    int iters, T dt2, int raw, T* res_p, T* res_d,
                    size_t part_scen, size_t dpart_scen, size_t res_scen) {
  __shared__ T sh[THREADS];
  const size_t s = blockIdx.x;
  part += part_scen * s;
  res_p += res_scen * s;
  if (dpart != nullptr) {
    dpart += dpart_scen * s;
    res_d += res_scen * s;
  }
  for (int it = 0; it < iters; ++it) {
    const T tp = sum_partials(part + static_cast<size_t>(it) * stride,
                              stride, sh);
    if (threadIdx.x == 0) res_p[it] = raw ? tp : sqrt(tp);
    if (dpart != nullptr) {
      const T td = sum_partials(dpart + static_cast<size_t>(it) * dstride,
                                dstride, sh);
      if (threadIdx.x == 0) res_d[it] = dt2 * sqrt(td);
    }
  }
}

}  // namespace residuals
}  // namespace admm
