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

#include "cluster_pcg.cuh"

namespace admm {
namespace cg {

// The ELL row of the cluster solve: slot k of row i at idx_t[k n + i],
// vals_t[k n + i] (a slot-major copy of the (n,K) arrays); the slots are
// added in order.
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

  __device__ View stage(int lo, int, T*) const {
    return {idx_t + lo, vals_t + lo, n};
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

template <typename T>
int ell_solve(const T* b, const T* x0, const T* diag, const int* idx_t,
              const T* vals_t, int K, int H, int n, int n_iters, T* x,
              T* scratch, void* stream) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const EllRows<T> row{idx_t, vals_t, K, n};
  return cluster_pcg::solve<T>(row, H, 0, b, x0, diag, n, n_iters, x,
                               scratch, stream);
}

}  // namespace cg
}  // namespace admm

extern "C" {

// idx_t, vals_t: the ELL arrays slot-major, (K,n); H: the largest
// |idx_t[k,i] - i| (a row's columns must lie within H of it); scratch as
// for cg_dia_solve. Returns the first nonzero cudaError_t, or 0.
int cg_ell_solve_f32(const float* b, const float* x0, const float* diag,
                     const int* idx_t, const float* vals_t, int K, int H,
                     int n, int n_iters, float* x, float* scratch,
                     void* stream) {
  return admm::cg::ell_solve<float>(b, x0, diag, idx_t, vals_t, K, H, n,
                                    n_iters, x, scratch, stream);
}

int cg_ell_solve_f64(const double* b, const double* x0, const double* diag,
                     const int* idx_t, const double* vals_t, int K, int H,
                     int n, int n_iters, double* x, double* scratch,
                     void* stream) {
  return admm::cg::ell_solve<double>(b, x0, diag, idx_t, vals_t, K, H, n,
                                     n_iters, x, scratch, stream);
}

}  // extern "C"
