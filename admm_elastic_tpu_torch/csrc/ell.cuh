// ELL (ELLPACK) matvec rows: the row of the banded whole-timestep
// kernel's ELL mode (banded_step.cu); the cluster solve (cg_ell.cu) reads
// its rows in the same slot order.
#pragma once

#include "common.cuh"

namespace admm {
namespace ell {

// out = row i of A x for x of shape (n,3) row-major: y[i] = sum_k
// vals[i,k] * x[idx[i,k]], slots summed in order k = 0..K-1. idx and vals
// are (n,K) row-major (core/solver.assemble_A_hat_ell): the padding slots
// of a row hold value 0 and the row's own index.
template <typename T>
__device__ __forceinline__ void ell_row(const int* __restrict__ idx,
                                        const T* __restrict__ vals, int K,
                                        int i, const T* x, T out[3]) {
  T a0 = T(0), a1 = T(0), a2 = T(0);
  const size_t base = static_cast<size_t>(i) * K;
  for (int k = 0; k < K; ++k) {
    const size_t j = static_cast<size_t>(idx[base + k]);
    const T w = vals[base + k];
    a0 = a0 + w * x[3 * j];
    a1 = a1 + w * x[3 * j + 1];
    a2 = a2 + w * x[3 * j + 2];
  }
  out[0] = a0;
  out[1] = a1;
  out[2] = a2;
}

}  // namespace ell
}  // namespace admm
