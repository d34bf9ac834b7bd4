// What the whole-timestep windows (banded_step.cu, lattice_step.cu,
// cloth_step.cu) share: the per-vertex kernels that open and close a
// timestep, and the cluster solves they hand each ADMM iteration's global
// solve to (cg_dia.cu, cg_ell.cu, cg_dia.cu's geometric and cg_ell.cu's
// algebraic multigrid mode; C entry points of the same library, so each
// solve kernel is instantiated once).
#pragma once

#include <cuda_runtime.h>

extern "C" {
int cg_dia_solve_f32(const float* b, const float* x0, const float* diag,
                     const float* dia, const int* offsets, int D, int H,
                     int n, int n_iters, int diag_inv, float* x,
                     float* scratch, void* stream);
int cg_dia_solve_f64(const double* b, const double* x0, const double* diag,
                     const double* dia, const int* offsets, int D, int H,
                     int n, int n_iters, int diag_inv, double* x,
                     double* scratch, void* stream);
int cg_ell_solve_f32(const float* b, const float* x0, const float* diag,
                     const int* idx_t, const float* vals_t, int K, int H,
                     int n, int n_iters, int diag_inv, float* x,
                     float* scratch, void* stream);
int cg_ell_solve_f64(const double* b, const double* x0, const double* diag,
                     const int* idx_t, const double* vals_t, int K, int H,
                     int n, int n_iters, int diag_inv, double* x,
                     double* scratch, void* stream);
int mg_dia_solve_f32(const float* b, const float* x0, const float* dia,
                     const int* offsets, int D, int n, int n_iters,
                     const void* mg, float* x, float* scratch, void* stream);
int mg_dia_solve_f64(const double* b, const double* x0, const double* dia,
                     const int* offsets, int D, int n, int n_iters,
                     const void* mg, double* x, double* scratch,
                     void* stream);
int uamg_ell_solve_f32(const float* b, const float* x0, const int* idx_t,
                       const float* vals_t, int K, int n, int n_iters,
                       const void* uamg, float* x, float* scratch,
                       void* stream);
int uamg_ell_solve_f64(const double* b, const double* x0, const int* idx_t,
                       const double* vals_t, int K, int n, int n_iters,
                       const void* uamg, double* x, double* scratch,
                       void* stream);
}

namespace admm {
namespace window {

constexpr int THREADS = 128;

inline dim3 blocks_for(int count) { return dim3((count + THREADS - 1) / THREADS); }

// The prologue of a timestep, per vertex: v += dt g where m > 0; x_pre =
// x; x += dt v; M xbar = m x.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    kick_kernel(T* x, T* v, T* xpre, T* mxbar, const T* __restrict__ mass,
                T dt, T g0, T g1, T g2, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T m = mass[i];
  const T dtg[3] = {g0, g1, g2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const size_t q = 3 * static_cast<size_t>(i) + c;
    const T vc = v[q] + (m > T(0) ? dtg[c] : T(0));
    v[q] = vc;
    const T xs = x[q];
    xpre[q] = xs;
    const T xn = xs + dt * vc;
    x[q] = xn;
    mxbar[q] = m * xn;
  }
}

// The epilogue, per vertex: v = (x - x_pre) (1/dt).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    end_kernel(const T* __restrict__ x, T* v, const T* __restrict__ xpre,
               T inv_dt, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const size_t q = 3 * static_cast<size_t>(i) + c;
    v[q] = (x[q] - xpre[q]) * inv_dt;
  }
}

// The global solve of an ADMM iteration, in place: x = A^-1 rhs by
// n_iters Jacobi-PCG iterations from x, D^-1 = invd as given, on one
// cluster. Dia rows (D offsets, ell_idx_t null) or slot-major ELL rows (K
// slots, dia null); H: how far a row reaches.
inline int solve(const float* rhs, float* x, const float* invd,
                 const float* dia, const int* offsets, int D,
                 const int* ell_idx_t, const float* ell_vals_t, int K, int H,
                 int n, int n_iters, float* scratch, cudaStream_t st) {
  return K > 0 ? cg_ell_solve_f32(rhs, x, invd, ell_idx_t, ell_vals_t, K, H,
                                  n, n_iters, 1, x, scratch, st)
               : cg_dia_solve_f32(rhs, x, invd, dia, offsets, D, H, n,
                                  n_iters, 1, x, scratch, st);
}

inline int solve(const double* rhs, double* x, const double* invd,
                 const double* dia, const int* offsets, int D,
                 const int* ell_idx_t, const double* ell_vals_t, int K,
                 int H, int n, int n_iters, double* scratch,
                 cudaStream_t st) {
  return K > 0 ? cg_ell_solve_f64(rhs, x, invd, ell_idx_t, ell_vals_t, K, H,
                                  n, n_iters, 1, x, scratch, st)
               : cg_dia_solve_f64(rhs, x, invd, dia, offsets, D, H, n,
                                  n_iters, 1, x, scratch, st);
}

// The global solve under preconditioner="amg", in place: n_iters PCG
// iterations preconditioned by the geometric V-cycle (mg_vcycle.cuh) of
// the multigrid `mg` (an mg::Host), on dia rows, on one cluster.
inline int mg_solve(const float* rhs, float* x, const float* dia,
                    const int* offsets, int D, int n, int n_iters,
                    const void* mg, float* scratch, cudaStream_t st) {
  return mg_dia_solve_f32(rhs, x, dia, offsets, D, n, n_iters, mg, x,
                          scratch, st);
}

inline int mg_solve(const double* rhs, double* x, const double* dia,
                    const int* offsets, int D, int n, int n_iters,
                    const void* mg, double* scratch, cudaStream_t st) {
  return mg_dia_solve_f64(rhs, x, dia, offsets, D, n, n_iters, mg, x,
                          scratch, st);
}

// The global solve of the ELL mode under preconditioner="amg", in place:
// n_iters PCG iterations preconditioned by the aggregation V-cycle
// (mg_vcycle.cuh AggLevels) of `uamg` (an mg::AggHost), on slot-major ELL
// rows, on one cluster.
inline int uamg_solve(const float* rhs, float* x, const int* ell_idx_t,
                      const float* ell_vals_t, int K, int n, int n_iters,
                      const void* uamg, float* scratch, cudaStream_t st) {
  return uamg_ell_solve_f32(rhs, x, ell_idx_t, ell_vals_t, K, n, n_iters,
                            uamg, x, scratch, st);
}

inline int uamg_solve(const double* rhs, double* x, const int* ell_idx_t,
                      const double* ell_vals_t, int K, int n, int n_iters,
                      const void* uamg, double* scratch, cudaStream_t st) {
  return uamg_ell_solve_f64(rhs, x, ell_idx_t, ell_vals_t, K, n, n_iters,
                            uamg, x, scratch, st);
}

// A launch's error, or the one it left behind. A window's host call
// starts with none left over (clear_errors: an earlier call returned its
// own) and leaves none behind when it returns one (failed).
inline int launched() { return static_cast<int>(cudaGetLastError()); }
inline void clear_errors() { cudaGetLastError(); }
inline int failed(int err) {
  cudaGetLastError();
  return err;
}

}  // namespace window
}  // namespace admm
