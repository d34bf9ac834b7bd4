// Fixed-iteration Jacobi-PCG with a sparse-DIAgonal matvec, for Hopper.
//
// Replaces: admm_elastic_tpu/ops/pallas/cg_dia.py, cg_dia_solve (kernel
// _make_kernel), which keeps the whole solve in VMEM and loops inside one
// launch.
//
// Solves A_hat X = B for X, B of shape (n,3) stored row-major. The three
// columns are one system: alpha and beta are single scalars over all 3n
// values, with the pAp > 0 and rz > 0 guards of the reference. The matvec
// is y[i] = sum_d dia[d,i] * x[i + off_d], diagonals summed in offset
// order; reads past either end give 0.
//
// What bounds it on this card: launches and L2 bytes. At the 100k-tet
// beam (n = 22,386, 19 diagonals) one iteration moves about 2.5 MB in f32
// (19 diagonal rows + the vectors), all of it L2-resident, and does ~1.6
// Mflop: microseconds of work, so each iteration costs what its three
// launches cost.
//
// Design: one C entry point runs the whole solve from a host loop inside
// this library: 1 + 3 * n_iters launches on the caller's stream, with no
// scalar ever read back to the host. Blocks cannot sync with each other
// without a cooperative launch, so each iteration is split where a global
// reduction is needed:
//   matvec_dot : Ap = A p, per-block partial sums of p.Ap
//   update     : every block sums the pAp partials itself (same fixed
//                order in every block), alpha; x += alpha p;
//                r -= alpha Ap; partial sums of r.(D^-1 r)
//   direction  : every block sums both rz partial sets (old, new), beta;
//                p = D^-1 r + beta p
// The rz partials ping-pong between two arrays, so no kernel reads a value
// another block of the same launch writes. All reductions are fixed-order
// trees, never atomics: two runs are bitwise equal.

#include "dia.cuh"

namespace admm {
namespace cg {

constexpr int THREADS = 256;
using dia::dia_row;
using dia::MAX_DIAGONALS;
using dia::Offsets;
using dia::sum_partials;

// r = b - A x0; x = x0; p = D^-1 r; partials of r.(D^-1 r)
template <typename T>
__global__ void __launch_bounds__(THREADS)
    init_kernel(const T* __restrict__ b, const T* __restrict__ x0,
                const T* __restrict__ diag, const T* __restrict__ dia,
                Offsets offs, int D, int n, T* __restrict__ x,
                T* __restrict__ r, T* __restrict__ p, T* __restrict__ rz_part) {
  __shared__ T sh[THREADS];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  T local = T(0);
  if (i < n) {
    T ax[3];
    dia_row(dia, offs, D, n, i, x0, ax);
    const T invd = T(1) / diag[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T ri = b[3 * i + c] - ax[c];
      const T zi = invd * ri;
      r[3 * i + c] = ri;
      p[3 * i + c] = zi;
      x[3 * i + c] = x0[3 * i + c];
      local = local + ri * zi;
    }
  }
  const T tot = block_sum(local, sh);
  if (threadIdx.x == 0) rz_part[blockIdx.x] = tot;
}

// Ap = A p; partials of p.Ap
template <typename T>
__global__ void __launch_bounds__(THREADS)
    matvec_dot_kernel(const T* __restrict__ p, const T* __restrict__ dia,
                      Offsets offs, int D, int n, T* __restrict__ Ap,
                      T* __restrict__ pap_part) {
  __shared__ T sh[THREADS];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  T local = T(0);
  if (i < n) {
    T ap[3];
    dia_row(dia, offs, D, n, i, p, ap);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Ap[3 * i + c] = ap[c];
      local = local + p[3 * i + c] * ap[c];
    }
  }
  const T tot = block_sum(local, sh);
  if (threadIdx.x == 0) pap_part[blockIdx.x] = tot;
}

// alpha = rz / pAp; x += alpha p; r -= alpha Ap; partials of r.(D^-1 r)
template <typename T>
__global__ void __launch_bounds__(THREADS)
    update_kernel(const T* __restrict__ p, const T* __restrict__ Ap,
                  const T* __restrict__ diag, const T* __restrict__ pap_part,
                  const T* __restrict__ rz_old_part, int nb, int n,
                  T* __restrict__ x, T* __restrict__ r,
                  T* __restrict__ rz_new_part) {
  __shared__ T sh[THREADS];
  const T pAp = sum_partials(pap_part, nb, sh);
  const T rz = sum_partials(rz_old_part, nb, sh);
  const T alpha = rz / (pAp > T(0) ? pAp : T(1));
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  T local = T(0);
  if (i < n) {
    const T invd = T(1) / diag[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[3 * i + c] = x[3 * i + c] + alpha * p[3 * i + c];
      const T ri = r[3 * i + c] - alpha * Ap[3 * i + c];
      r[3 * i + c] = ri;
      local = local + ri * (invd * ri);
    }
  }
  const T tot = block_sum(local, sh);
  if (threadIdx.x == 0) rz_new_part[blockIdx.x] = tot;
}

// beta = rz_new / rz_old; p = D^-1 r + beta p
template <typename T>
__global__ void __launch_bounds__(THREADS)
    direction_kernel(const T* __restrict__ r, const T* __restrict__ diag,
                     const T* __restrict__ rz_old_part,
                     const T* __restrict__ rz_new_part, int nb, int n,
                     T* __restrict__ p) {
  __shared__ T sh[THREADS];
  const T rz = sum_partials(rz_old_part, nb, sh);
  const T rz_new = sum_partials(rz_new_part, nb, sh);
  const T beta = rz_new / (rz > T(0) ? rz : T(1));
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const T invd = T(1) / diag[i];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      p[3 * i + c] = invd * r[3 * i + c] + beta * p[3 * i + c];
  }
}

// scratch: r, p, Ap (3n each); partials (3 * nb): pAp, rz[0], rz[1]
template <typename T>
int solve(const T* b, const T* x0, const T* diag, const T* dia,
          const int* offsets, int D, int n, int n_iters, T* x, T* r, T* p,
          T* Ap, T* partials, void* stream) {
  if (D < 1 || D > MAX_DIAGONALS || n < 1 || n_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs{};
  for (int d = 0; d < D; ++d) offs.v[d] = offsets[d];
  const int nb = (n + THREADS - 1) / THREADS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  T* pap = partials;
  T* rz[2] = {partials + nb, partials + 2 * nb};
  cudaError_t err;

  init_kernel<T><<<nb, THREADS, 0, st>>>(b, x0, diag, dia, offs, D, n, x, r,
                                         p, rz[0]);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int it = 0; it < n_iters; ++it) {
    const T* rz_old = rz[it & 1];
    T* rz_new = rz[(it + 1) & 1];
    matvec_dot_kernel<T><<<nb, THREADS, 0, st>>>(p, dia, offs, D, n, Ap, pap);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    update_kernel<T><<<nb, THREADS, 0, st>>>(p, Ap, diag, pap, rz_old, nb, n,
                                             x, r, rz_new);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    direction_kernel<T><<<nb, THREADS, 0, st>>>(r, diag, rz_old, rz_new, nb,
                                                n, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace cg
}  // namespace admm

extern "C" {

// offsets is a host array of D ints. Returns the first nonzero
// cudaError_t of the launches, or 0.
int cg_dia_solve_f32(const float* b, const float* x0, const float* diag,
                     const float* dia, const int* offsets, int D, int n,
                     int n_iters, float* x, float* r, float* p, float* Ap,
                     float* partials, void* stream) {
  return admm::cg::solve<float>(b, x0, diag, dia, offsets, D, n, n_iters, x,
                                r, p, Ap, partials, stream);
}

int cg_dia_solve_f64(const double* b, const double* x0, const double* diag,
                     const double* dia, const int* offsets, int D, int n,
                     int n_iters, double* x, double* r, double* p, double* Ap,
                     double* partials, void* stream) {
  return admm::cg::solve<double>(b, x0, diag, dia, offsets, D, n, n_iters, x,
                                 r, p, Ap, partials, stream);
}

int cg_dia_partials(int n) {
  return 3 * ((n + admm::cg::THREADS - 1) / admm::cg::THREADS);
}

}  // extern "C"
