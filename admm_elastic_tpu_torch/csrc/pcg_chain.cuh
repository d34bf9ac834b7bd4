// Jacobi-PCG vector updates as a chain of plain launches: the kernels of
// the single fused update (cg_step.cu; the whole solves, cg_dia.cu and
// cg_ell.cu, run on one cluster instead: cluster_pcg.cuh).
//
// Vectors are (n,3) row-major; the three columns are one system, so alpha
// and beta are single scalars over all 3n values, with the pAp > 0 and
// rz > 0 guards of the reference. Blocks cannot sync with each other
// without a cooperative launch, so the update is split where a global
// reduction is needed:
//   dot        : per-block partial sums of p.Ap
//   update     : every block sums the pAp partials itself (same fixed
//                order in every block), alpha; x += alpha p;
//                r -= alpha Ap; partial sums of r.(D^-1 r)
//   direction  : every block sums the new rz partials, beta;
//                p = D^-1 r + beta p
// All reductions are fixed-order trees, never atomics: two runs are
// bitwise equal. Input and output vectors of update and direction may be
// the same buffer (each thread reads its own entries before it writes
// them), so those pointers carry no __restrict__.
#pragma once

#include "dia.cuh"

namespace admm {
namespace chain {

constexpr int THREADS = 256;

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

// Internal linkage: every source that includes this header gets its own
// copies of the kernels.
namespace {

// partials of p.Ap, for an Ap computed outside (the fused update)
template <typename T>
__global__ void __launch_bounds__(THREADS)
    dot_kernel(const T* __restrict__ p, const T* __restrict__ Ap, int n,
               T* __restrict__ pap_part) {
  __shared__ T sh[THREADS];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  T local = T(0);
  if (i < n) {
#pragma unroll
    for (int c = 0; c < 3; ++c) local = local + p[3 * i + c] * Ap[3 * i + c];
  }
  const T tot = block_sum(local, sh);
  if (threadIdx.x == 0) pap_part[blockIdx.x] = tot;
}

// alpha = rz / pAp; x' = x + alpha p; r' = r - alpha Ap; partials of
// r'.(D^-1 r'). rz is the sum of n_rz partials (1 for a scalar).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    update_kernel(const T* __restrict__ p, const T* __restrict__ Ap,
                  const T* __restrict__ invd, const T* __restrict__ pap_part,
                  int n_pap, const T* rz_part, int n_rz, int n, const T* x_in,
                  const T* r_in, T* x_out, T* r_out,
                  T* __restrict__ rz_new_part) {
  __shared__ T sh[THREADS];
  const T pAp = dia::sum_partials(pap_part, n_pap, sh);
  const T rz = dia::sum_partials(rz_part, n_rz, sh);
  const T alpha = rz / (pAp > T(0) ? pAp : T(1));
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  T local = T(0);
  if (i < n) {
    const T d = invd[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x_out[3 * i + c] = x_in[3 * i + c] + alpha * p[3 * i + c];
      const T ri = r_in[3 * i + c] - alpha * Ap[3 * i + c];
      r_out[3 * i + c] = ri;
      local = local + ri * (d * ri);
    }
  }
  const T tot = block_sum(local, sh);
  if (threadIdx.x == 0) rz_new_part[blockIdx.x] = tot;
}

// beta = rz' / rz; p' = D^-1 r + beta p. rz is the sum of n_rz partials,
// rz' of n_new; block 0 writes rz' to rz_out when it is given.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    direction_kernel(const T* __restrict__ r, const T* __restrict__ invd,
                     const T* rz_part, int n_rz,
                     const T* __restrict__ rz_new_part, int n_new, int n,
                     const T* p_in, T* p_out, T* rz_out) {
  __shared__ T sh[THREADS];
  const T rz = dia::sum_partials(rz_part, n_rz, sh);
  const T rz_new = dia::sum_partials(rz_new_part, n_new, sh);
  const T beta = rz_new / (rz > T(0) ? rz : T(1));
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const T d = invd[i];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      p_out[3 * i + c] = d * r[3 * i + c] + beta * p_in[3 * i + c];
  }
  if (rz_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    *rz_out = rz_new;
}

}  // namespace

}  // namespace chain
}  // namespace admm
