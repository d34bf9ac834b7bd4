// Sparse-DIAgonal matvec rows and fixed-order partial sums: the device
// functions shared by the Jacobi-PCG kernels (cg_dia.cu) and the whole-
// timestep kernels (banded_step.cu, cloth_step.cu).
#pragma once

#include "common.cuh"

namespace admm {
namespace dia {

constexpr int MAX_DIAGONALS = 48;

struct Offsets {
  int v[MAX_DIAGONALS];
};

// out = row i of A x for x of shape (n,3) row-major: y[i] = sum_d
// dia[d,i] * x[i + off_d], diagonals summed in offset order; reads past
// either end give 0.
template <typename T>
__device__ __forceinline__ void dia_row(const T* __restrict__ dia,
                                        const Offsets& offs, int D, int n,
                                        int i, const T* x, T out[3]) {
  T a0 = T(0), a1 = T(0), a2 = T(0);
  for (int d = 0; d < D; ++d) {
    const int j = i + offs.v[d];
    if (j >= 0 && j < n) {
      const T w = dia[static_cast<size_t>(d) * n + i];
      a0 = a0 + w * x[3 * j];
      a1 = a1 + w * x[3 * j + 1];
      a2 = a2 + w * x[3 * j + 2];
    }
  }
  out[0] = a0;
  out[1] = a1;
  out[2] = a2;
}

// out = row i of A x for a symmetric A stored at offsets >= 0 only
// (dia[d,i] = A[i, i+off_d]), in the cloth Pallas kernel's order: per
// diagonal, the upper term dia[d,i] x[i+off], then the mirrored lower
// term dia[d,i-off] x[i-off]; terms outside the matrix are skipped.
template <typename T>
__device__ __forceinline__ void dia_row_sym(const T* __restrict__ dia,
                                            const Offsets& offs, int D, int n,
                                            int i, const T* x, T out[3]) {
  T a0 = T(0), a1 = T(0), a2 = T(0);
  for (int d = 0; d < D; ++d) {
    const int off = offs.v[d];
    const T* row = dia + static_cast<size_t>(d) * n;
    if (off == 0) {
      const T w = row[i];
      a0 = a0 + w * x[3 * i];
      a1 = a1 + w * x[3 * i + 1];
      a2 = a2 + w * x[3 * i + 2];
      continue;
    }
    const int j = i + off;
    if (j < n) {
      const T w = row[i];
      a0 = a0 + w * x[3 * j];
      a1 = a1 + w * x[3 * j + 1];
      a2 = a2 + w * x[3 * j + 2];
    }
    const int l = i - off;
    if (l >= 0) {
      const T w = row[l];
      a0 = a0 + w * x[3 * l];
      a1 = a1 + w * x[3 * l + 1];
      a2 = a2 + w * x[3 * l + 2];
    }
  }
  out[0] = a0;
  out[1] = a1;
  out[2] = a2;
}

// Sum of `count` per-block partials, in the same order in every block.
template <typename T>
__device__ __forceinline__ T sum_partials(const T* part, int count, T* sh) {
  T acc = T(0);
  for (int i = threadIdx.x; i < count; i += blockDim.x) acc = acc + part[i];
  return block_sum(acc, sh);
}

}  // namespace dia
}  // namespace admm
