// Fixed-iteration Jacobi-PCG with a sparse-DIAgonal matvec, for Hopper.
//
// Replaces: admm_elastic_tpu/ops/pallas/cg_dia.py, cg_dia_solve (kernel
// _make_kernel), which keeps the whole solve in VMEM and loops inside one
// launch.
//
// Solves A_hat X = B for X, B of shape (n,3) stored row-major. The matvec
// is y[i] = sum_d dia[d,i] * x[i + off_d], diagonals summed in offset
// order; reads past either end of the matrix give 0 (dia.cuh's Rows,
// which reads the CTA's window of the vectors).
//
// What bounds it on this card: latency, not bytes. At the 100k-tet beam
// (n = 22,386, 19 diagonals) one iteration moves about 2.5 MB in f32 (19
// diagonal rows + the vectors) and does ~1.6 Mflop: microseconds of work
// behind two global reductions. The host loop it replaces paid three
// launches an iteration (1 + 3 n_iters in all, ~5.5 us each).
//
// Design: ONE launch on one 16-CTA thread-block cluster (cluster_pcg.cuh):
// every CTA keeps its slab of rows, a window of the vectors over the
// band's reach (H = 567 rows at tet100k) and, where they fit (f32 at
// tet100k: 19 x 1,400 rows), its diagonals in shared memory; the owners
// push the band's edge rows of r and the dots' partials to the other CTAs
// with remote stores, counted on mbarriers. Where the window does not fit
// (f64 past ~25,000 rows of tet100k's band, f32 past ~60,000) the vectors
// live in global memory and each stage ends with a cluster barrier: one
// cluster's 16 SMs then move what the chain's 132 moved (PERF.md records
// where one cluster stops paying). Fixed-order sums, no atomics.
//
// The same rows also serve the multigrid mode (mg_dia_solve_*, the PCG
// with the geometric V-cycle of mg_vcycle.cuh as its preconditioner): the
// global solve of the banded and cloth windows under
// preconditioner="amg".

#include "cluster_pcg.cuh"
#include "dia.cuh"
#include "mg_vcycle.cuh"

namespace admm {
namespace cg {

template <typename T>
using DiaRows = dia::Rows<T>;

template <typename T>
int solve(const T* b, const T* x0, const T* diag, const T* dia_vals,
          const int* offsets, int D, int H, int n, int n_iters, int diag_inv,
          T* x, T* scratch, void* stream) {
  if (D < 1 || D > dia::MAX_DIAGONALS)
    return static_cast<int>(cudaErrorInvalidValue);
  DiaRows<T> row{dia_vals, {}, D, n};
  for (int d = 0; d < D; ++d) {
    row.offs.v[d] = offsets[d];
    if (offsets[d] > H || -offsets[d] > H)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return cluster_pcg::solve<T>(row, H, D, b, x0, diag, diag_inv, n,
                               n_iters, x, scratch, stream);
}

// The multigrid mode (mg_vcycle.cuh): the same dia rows, the V-cycle as
// the preconditioner.
template <typename T>
int mg_solve(const T* b, const T* x0, const T* dia_vals, const int* offsets,
             int D, int n, int n_iters, const void* mg, T* x, T* scratch,
             void* stream) {
  if (D < 1 || D > dia::MAX_DIAGONALS)
    return static_cast<int>(cudaErrorInvalidValue);
  DiaRows<T> row{dia_vals, {}, D, n};
  for (int d = 0; d < D; ++d) row.offs.v[d] = offsets[d];
  return admm::mg::solve<T, admm::mg::GridLevels<T>>(row, D, mg, b, x0, n,
                                                     n_iters, x, scratch,
                                                     stream);
}

}  // namespace cg
}  // namespace admm

extern "C" {

// offsets is a host array of D ints, H at least their largest magnitude;
// diag is A's diagonal, or with diag_inv = 1 its inverse; x may be x0;
// scratch holds cg_cluster_plan's scratch count (nullptr when it is 0).
// Returns the first nonzero cudaError_t of the checks and the launch
// (cudaErrorInvalidClusterSize if the card cannot place the cluster), or
// 0.
#define ADMM_CG_DIA_ENTRY(T, SUFFIX)                                          \
  int cg_dia_solve_##SUFFIX(const T* b, const T* x0, const T* diag,         \
                            const T* dia, const int* offsets, int D, int H,  \
                            int n, int n_iters, int diag_inv, T* x,          \
                            T* scratch, void* stream) {                      \
    return admm::cg::solve<T>(b, x0, diag, dia, offsets, D, H, n, n_iters,   \
                              diag_inv, x, scratch, stream);                 \
  }                                                                          \
  int cg_dia_prepare_##SUFFIX(int D, int H, int n) {                         \
    return admm::cluster_pcg::prepare<T, admm::cg::DiaRows<T>>(H, D, n);     \
  }

// cg_dia_prepare_*: the set-up of a solve of n rows, D diagonals reaching
// H, without a launch (before a CUDA graph captures such solves).
ADMM_CG_DIA_ENTRY(float, f32)
ADMM_CG_DIA_ENTRY(double, f64)

// The multigrid mode: n_iters V-cycle PCG iterations from x0 (x may be
// x0); mg points to an mg::Host (ops/kernels/mg.py MGHost) whose planes
// are of the solve's type; scratch holds mg_dia_plan's scratch count.
// mg_dia_prepare_*: the set-up of such a solve, without a launch.
#define ADMM_MG_DIA_ENTRY(T, SUFFIX)                                          \
  int mg_dia_solve_##SUFFIX(const T* b, const T* x0, const T* dia,          \
                            const int* offsets, int D, int n, int n_iters,   \
                            const void* mg, T* x, T* scratch,                \
                            void* stream) {                                  \
    return admm::cg::mg_solve<T>(b, x0, dia, offsets, D, n, n_iters, mg, x,  \
                                 scratch, stream);                           \
  }                                                                          \
  int mg_dia_prepare_##SUFFIX(int D, int n, int nc2) {                       \
    return admm::mg::prepare<T, admm::mg::GridLevels<T>,                    \
                             admm::cg::DiaRows<T>>(D, n, nc2);               \
  }

ADMM_MG_DIA_ENTRY(float, f32)
ADMM_MG_DIA_ENTRY(double, f64)

// The multigrid solve's layout for n rows, D fine diagonals and nc2
// coarsest dofs on the current device: out = dynamic shared memory a CTA
// in bytes, fine diagonals in shared memory (0/1), elements of global
// scratch. Returns a cudaError_t.
int mg_dia_plan(int n, int D, int nc2, int elem_bytes, long long* out) {
  admm::mg::Plan p;
  const int err = admm::mg::plan_for_device(n, D, nc2, elem_bytes, &p);
  if (err != 0) return err;
  out[0] = p.smem_bytes;
  out[1] = p.mat_smem;
  out[2] = p.scratch;
  return 0;
}

// The layout of a cluster solve of n rows whose rows reach H rows away
// (cg_dia_solve: mat_per_row = D; cg_ell_solve: 0) on the current device:
// out = slab rows, window rows, vectors in shared memory (0/1), matrix
// rows in shared memory (0/1), dynamic shared memory a CTA in bytes,
// elements of global scratch. Returns a cudaError_t.
int cg_cluster_plan(int n, int H, int mat_per_row, int elem_bytes,
                    long long* out) {
  admm::cluster_pcg::Plan p;
  const int err = admm::cluster_pcg::plan_for_device(n, H, mat_per_row,
                                                     elem_bytes, &p);
  if (err != 0) return err;
  out[0] = p.slab;
  out[1] = p.window;
  out[2] = p.vec_smem;
  out[3] = p.mat_smem;
  out[4] = p.smem_bytes;
  out[5] = p.scratch;
  return 0;
}

}  // extern "C"
