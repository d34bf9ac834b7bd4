// Fixed-budget Jacobi-PCG inside a persistent cooperative kernel: the CG
// stages shared by the whole-timestep kernels (banded_step.cu,
// cloth_step.cu), which differ only in the matvec.
//
// Every block sums the per-block partials itself in one fixed order, so
// all blocks hold the same scalars and two runs are bitwise equal. The
// partials ping-pong between two halves of `part` (2 x gridDim.x): a half
// is rewritten only after a grid barrier that follows every read of it.
#pragma once

#include <cooperative_groups.h>

#include "dia.cuh"

namespace admm {
namespace coop {

namespace cgr = cooperative_groups;

template <typename T>
struct PcgVecs {
  T* x;
  T* r;   // holds r = b - A x on entry
  T* p;   // holds p = D^-1 r on entry
  T* ap;
  const T* __restrict__ invd;
  T* part;  // 2 * gridDim.x
  int n;
};

// Called by every thread after the phase that wrote r and p, with the
// thread's share of r.p in `local`. row(i, y, out) writes row i of A y
// (vectors of shape (n,3), row-major). Then, iters times (three stages,
// a grid barrier after each):
//   Ap = A p, partials of p.Ap
//   alpha = rz / pAp; x += alpha p; r -= alpha Ap; partials of (r D^-1) r
//   beta = rz' / rz; p = D^-1 r + beta p
// with the pAp > 0 and rz > 0 guards of the Pallas kernels.
template <typename T, typename Row>
__device__ __forceinline__ void pcg(cgr::grid_group& grid,
                                    const PcgVecs<T>& v, int iters, T local,
                                    const Row& row, T* sh) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gstride = gridDim.x * blockDim.x;
  const int nb = gridDim.x;
  T* pap_part = v.part;
  T* rz_part = v.part + nb;

  T tot = block_sum(local, sh);
  if (threadIdx.x == 0) rz_part[blockIdx.x] = tot;
  grid.sync();
  T rz = dia::sum_partials(rz_part, nb, sh);

  for (int k = 0; k < iters; ++k) {
    local = T(0);
    for (int i = gtid; i < v.n; i += gstride) {
      T apv[3];
      row(i, static_cast<const T*>(v.p), apv);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const size_t q = 3 * static_cast<size_t>(i) + c;
        v.ap[q] = apv[c];
        local = local + v.p[q] * apv[c];
      }
    }
    tot = block_sum(local, sh);
    if (threadIdx.x == 0) pap_part[blockIdx.x] = tot;
    grid.sync();

    const T pAp = dia::sum_partials(pap_part, nb, sh);
    const T alpha = rz / (pAp > T(0) ? pAp : T(1));
    local = T(0);
    for (int i = gtid; i < v.n; i += gstride) {
      const T invd = v.invd[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const size_t q = 3 * static_cast<size_t>(i) + c;
        v.x[q] = v.x[q] + alpha * v.p[q];
        const T ri = v.r[q] - alpha * v.ap[q];
        v.r[q] = ri;
        local = local + ri * invd * ri;
      }
    }
    tot = block_sum(local, sh);
    if (threadIdx.x == 0) rz_part[blockIdx.x] = tot;
    grid.sync();

    const T rz_new = dia::sum_partials(rz_part, nb, sh);
    const T beta = rz_new / (rz > T(0) ? rz : T(1));
    for (int i = gtid; i < v.n; i += gstride) {
      const T invd = v.invd[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const size_t q = 3 * static_cast<size_t>(i) + c;
        v.p[q] = invd * v.r[q] + beta * v.p[q];
      }
    }
    rz = rz_new;
    grid.sync();
  }
}

}  // namespace coop
}  // namespace admm
