// Fixed-iteration Jacobi-PCG with an ELL gather matvec, for Hopper: the
// global solve of a tet mesh of any topology.
//
// Replaces: admm_elastic_tpu/ops/pallas/cg_ell.py, cg_ell_solve (kernel
// _make_kernel), which keeps the whole solve in VMEM with K lane gathers
// per matvec (and, for real meshes, never compiled for the TPU: Mosaic's
// gather stays within one 128-lane register).
//
// Solves A_hat X = B for X, B of shape (n,3) stored row-major, A_hat given
// as K column indices and values a row, slots summed in order as in
// ell.cuh's ell_row (whose copy here reads the CTA's window of the
// vectors).
//
// What bounds it on this card: latency and the L2 bytes of the matrix. At
// delaunay100k (n = 16,280, K = 32) one iteration reads the ELL arrays
// (4.2 MB in f32) and does ~3 Mflop behind two global reductions. The
// host loop it replaces paid three launches an iteration (1 + 3 n_iters in
// all, ~7.6 us each).
//
// Design: ONE launch on one 16-CTA thread-block cluster (cluster_pcg.cuh).
// Where a CTA's window of the vectors over the rows' reach fits in shared
// memory (H = 920 rows at delaunay100k in its grid numbering), the owners
// push the edge rows of r and the dots' partials to the other CTAs,
// counted on mbarriers. A mesh numbered without regard to its band
// reaches across all of n: then p lives in global memory, one copy that
// every CTA writes its slab of, and each stage ends with a cluster
// barrier. The matrix streams from L2 (it does not fit in the cluster's
// shared memory) in a slot-major copy (K,n) that the wrapper makes once a
// matrix, one thread a row reading its row's slots in order, so that a
// warp's load of one slot of its 32 rows is one coalesced line.
// Fixed-order sums, no atomics.
//
// The same rows also serve the algebraic multigrid mode (uamg_ell_solve_*,
// the PCG with mg_vcycle.cuh's aggregation V-cycle as its
// preconditioner): the global solve of the banded window's ELL mode under
// preconditioner="amg".

#include "cluster_pcg.cuh"
#include "mg_vcycle.cuh"

namespace admm {
namespace cg {

// The ELL row of the cluster solve: slot k of row i at idx_t[k n + i],
// vals_t[k n + i] (a slot-major copy of the (n,K) arrays); the slots are
// added in order. A sweep scenario's values start `off` further on; the
// indices are shared.
template <typename T>
struct EllRows {
  const int* __restrict__ idx_t;
  const T* __restrict__ vals_t;
  int K, n;

  struct View {
    const int* j;  // slot k of slab row li at j[k * stride + li]
    const T* w;
    int stride;
  };

  __device__ View stage(int lo, int, T*, size_t off = 0) const {
    return {idx_t + lo, vals_t + off + lo, n};
  }

  template <typename Col>
  __device__ __forceinline__ void operator()(const View& v, int, int li,
                                             const Col& col,
                                             T out[3]) const {
    T a0 = T(0), a1 = T(0), a2 = T(0);
    // several slots' loads in flight (a row's gathers wait on L2), as many
    // as the 64 registers a thread of a 1,024-thread CTA allow
#pragma unroll(sizeof(T) == 4 ? 8 : 4)
    for (int k = 0; k < K; ++k) {
      const size_t q = static_cast<size_t>(k) * v.stride + li;
      const T w = v.w[q];
      T c[3];
      col(v.j[q], c);
      a0 = a0 + w * c[0];
      a1 = a1 + w * c[1];
      a2 = a2 + w * c[2];
    }
    out[0] = a0;
    out[1] = a1;
    out[2] = a2;
  }
};

// n_scen scenarios: one cluster each, their values K n apart.
template <typename T>
int ell_solve(const T* b, const T* x0, const T* diag, const int* idx_t,
              const T* vals_t, int K, int H, int n, int n_iters, int diag_inv,
              T* x, T* scratch, void* stream, int n_scen = 1) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const EllRows<T> row{idx_t, vals_t, K, n};
  return cluster_pcg::solve<T>(row, H, 0, b, x0, diag, diag_inv, n,
                               n_iters, x, scratch, stream, n_scen,
                               static_cast<size_t>(K) * n);
}

// The algebraic multigrid mode (mg_vcycle.cuh): the same ELL rows,
// streamed from L2, the aggregation V-cycle as the preconditioner (fuse:
// as mg::solve).
template <typename T, bool PROBE = false>
int uamg_solve(const T* b, const T* x0, const int* idx_t, const T* vals_t,
               int K, int n, int n_iters, const void* uamg, T* x, T* scratch,
               void* stream, unsigned long long* stamps = nullptr,
               int fuse = -1) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const EllRows<T> row{idx_t, vals_t, K, n};
  return mg::solve<T, EllRows<T>, PROBE>(row, 0, uamg, b, x0, n, n_iters, x,
                                         scratch, stream, stamps, fuse);
}

}  // namespace cg
}  // namespace admm

extern "C" {

// idx_t, vals_t: the ELL arrays slot-major, (K,n); H: the largest
// |idx_t[k,i] - i| (a row's columns must lie within H of it); diag, x and
// scratch as for cg_dia_solve. Returns the first nonzero cudaError_t, or
// 0. cg_ell_prepare_*: the set-up of a solve of n rows reaching H,
// without a launch.
#define ADMM_CG_ELL_ENTRY(T, SUFFIX)                                          \
  int cg_ell_solve_##SUFFIX(const T* b, const T* x0, const T* diag,         \
                            const int* idx_t, const T* vals_t, int K, int H, \
                            int n, int n_iters, int diag_inv, T* x,          \
                            T* scratch, void* stream) {                      \
    return admm::cg::ell_solve<T>(b, x0, diag, idx_t, vals_t, K, H, n,       \
                                  n_iters, diag_inv, x, scratch, stream);    \
  }                                                                          \
  int cg_ell_prepare_##SUFFIX(int H, int n) {                                \
    return admm::cluster_pcg::prepare<T, admm::cg::EllRows<T>>(H, 0, n);     \
  }                                                                          \
  int cg_ell_sweep_##SUFFIX(const T* b, const T* x0, const T* diag,         \
                            const int* idx_t, const T* vals_t, int K, int H, \
                            int n, int n_iters, int diag_inv, T* x,          \
                            T* scratch, int n_scen, void* stream) {          \
    return admm::cg::ell_solve<T>(b, x0, diag, idx_t, vals_t, K, H, n,       \
                                  n_iters, diag_inv, x, scratch, stream,     \
                                  n_scen);                                   \
  }                                                                          \
  int cg_ell_clusters_##SUFFIX(int H, int n, int* out) {                     \
    return admm::cluster_pcg::active_clusters<T, admm::cg::EllRows<T>>(      \
        H, 0, n, out);                                                       \
  }

// cg_ell_sweep_*: n_scen solves of one shape in one launch, one cluster a
// scenario (cluster_pcg.cuh, Scenarios): b, x0, diag, x (n_scen,n,3) or
// (n_scen,n), vals_t (n_scen,K,n), idx_t (K,n) shared, scratch n_scen times
// the plan's. cg_ell_clusters_*: how many such clusters the card holds at
// once (cudaOccupancyMaxActiveClusters), into *out.
ADMM_CG_ELL_ENTRY(float, f32)
ADMM_CG_ELL_ENTRY(double, f64)

// The algebraic multigrid mode: n_iters V-cycle PCG iterations from x0 (x
// may be x0) on the slot-major ELL rows; uamg points to an mg::Host
// (ops/kernels/uamg.py UAMGHost) whose planes are of the solve's type;
// scratch holds mg_solve_plan's scratch count (cg_dia.cu).
// uamg_ell_prepare_*: the set-up of such a solve of n rows, without a
// launch.
#define ADMM_UAMG_ELL_ENTRY(T, SUFFIX)                                        \
  int uamg_ell_solve_##SUFFIX(const T* b, const T* x0, const int* idx_t,    \
                              const T* vals_t, int K, int n, int n_iters,    \
                              const void* uamg, T* x, T* scratch,            \
                              void* stream) {                                \
    return admm::cg::uamg_solve<T>(b, x0, idx_t, vals_t, K, n, n_iters,      \
                                   uamg, x, scratch, stream);                \
  }                                                                          \
  int uamg_ell_prepare_##SUFFIX(int n, const void* uamg) {                   \
    return admm::mg::prepare<T, admm::cg::EllRows<T>>(0, n, uamg);           \
  }

ADMM_UAMG_ELL_ENTRY(float, f32)
ADMM_UAMG_ELL_ENTRY(double, f64)

}  // extern "C"
