// Sparse-DIAgonal matvec rows and fixed-order partial sums: the dia row of
// the cluster solves (cg_dia.cu, cheb_dia.cu) and the block partials of
// the CG chain (pcg_chain.cuh).
#pragma once

#include "common.cuh"

namespace admm {
namespace dia {

constexpr int MAX_DIAGONALS = 48;

struct Offsets {
  int v[MAX_DIAGONALS];
};

// The dia row of the cluster solves (cg_dia.cu, cheb_dia.cu): row i of
// A y, y[i] = sum_d dia[d,i] * y[i + off_d], diagonals summed in offset
// order, terms past either end of the matrix skipped (as
// core/solver.dia_apply skips them). stage() copies the offsets, and the
// CTA's slab of the diagonals where they fit, into shared memory, else
// reads them from dia (D,n); `off` moves to a sweep scenario's diagonals.
template <typename T>
struct Rows {
  const T* __restrict__ dia;
  Offsets offs;
  int D, n;

  struct View {
    const T* w;  // the slab's diagonal d at w[d * stride + li]
    int stride;
    const int* offs;
  };

  __device__ View stage(int lo, int rows, T* smem, size_t off = 0) const {
    __shared__ int offs_s[MAX_DIAGONALS];
    for (int d = threadIdx.x; d < D; d += blockDim.x) offs_s[d] = offs.v[d];
    const T* vals = dia + off;
    if (smem == nullptr) return {vals + lo, n, offs_s};
    for (int q = threadIdx.x; q < D * rows; q += blockDim.x) {
      const int d = q / rows, li = q - d * rows;
      smem[q] = vals[static_cast<size_t>(d) * n + lo + li];
    }
    return {smem, rows, offs_s};
  }

  // out = row i (the slab's li-th) of A y, where col(j, c) writes y's row
  // j to c[0..2].
  template <typename Col>
  __device__ __forceinline__ void operator()(const View& v, int i, int li,
                                             const Col& col,
                                             T out[3]) const {
    T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const int j = i + v.offs[d];
      if (j >= 0 && j < n) {
        const T w = v.w[static_cast<size_t>(d) * v.stride + li];
        T c[3];
        col(j, c);
        a0 = a0 + w * c[0];
        a1 = a1 + w * c[1];
        a2 = a2 + w * c[2];
      }
    }
    out[0] = a0;
    out[1] = a1;
    out[2] = a2;
  }
};

// Sum of `count` per-block partials, in the same order in every block.
template <typename T>
__device__ __forceinline__ T sum_partials(const T* part, int count, T* sh) {
  T acc = T(0);
  for (int i = threadIdx.x; i < count; i += blockDim.x) acc = acc + part[i];
  return block_sum(acc, sh);
}

}  // namespace dia
}  // namespace admm
