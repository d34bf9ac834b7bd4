// One ADMM iteration's local phase on a tet mesh, without the global
// solve, for Hopper: the per-device kernel of the sharded banded stepper.
//
// Replaces: admm_elastic_tpu/ops/pallas/banded_local.py, banded_local_rhs
// (kernel _make_local_kernel, bodies _chunk_half_body and
// _anchor_coll_body), with model nh, stvk or arap:
//   element kernel, one thread per tet: F = u + sum_k cp x[idx_k], oriented
//     SVD; nh/stvk: warm-start guards, Newton prox, warm'; arap: z = (k U
//     diag(1,1,+-1) V^T + w2 F) / (w2 + k), warm untouched; u' = F - z;
//     rows[3k+a] = sum_b cp[4b+k] w2 (F - 2u')[3a+b]
//   vertex kernel, one thread per vertex: b = its incidence rows summed in
//     slot order (fixed order, no atomics); the anchor dual (exactly 0
//     where the anchor weight is 0) and its RHS aw2 (ancz - au'); the
//     floor/sphere/cylinder projections in declaration order, the
//     collision dual and its RHS cw2 (z - cu')
// and returns b, au', cu', u', warm'. Both phases are banded_step.cu's
// (banded_phases.cuh), so a sharded step at one device does the banded
// whole-timestep kernel's arithmetic. With collect (banded_local.py:63-70,
// 148, 182-231, 300-304) the kernels are the PRIMAL instantiations of
// those phases, which write each block's partial of the squared primal
// residual, and a third launch (residuals.cuh's finalize_kernel, one
// block) sums them into r2, in the order of the whole-timestep window's
// residual. The Pallas kernel's chunk windows, lane permutations and
// window accumulator are TPU layout and have no counterpart.
//
// Layout: vertex arrays (n,3) row-major; element planes (P,E) in the tet
// force's order; idx (4,E); the vertex -> (element, corner) incidence inc
// (n,S) with a sentinel >= 4E after the real slots
// (core/solver.assemble_transpose_incidence).
//
// What bounds it on this card: at the 100k-tet beam (E = 100,000, n =
// 22,386, f32) its inputs and outputs are ~22 MB (~6.7 us at HBM rate)
// and its arithmetic ~4,600 operations per element (the SVD and 5 Newton
// iterations; ~6.8 us at the f32 rate), but each element's operations
// form long dependent chains: like nh_local.cu, the element kernel is
// latency-bound, several times its bound (PERF.md).
//
// Design: two plain launches on the caller's stream, the vertex kernel
// after the element kernel. The outputs are new buffers: each thread first
// copies its element's (vertex's) duals into them and then runs the shared
// in-place phase on the copies, so the inputs are left untouched. Nothing
// written here is read through const __restrict__ pointers.

#include "banded_phases.cuh"

namespace admm {
namespace banded_local {

constexpr int THREADS = 128;
static_assert(THREADS == residuals::THREADS, "one block size");
using banded::MAX_SHAPES;
using banded::N_SCALARS;
using banded::SHAPE_PRM;

// The fields banded_phases.cuh reads, named as there.
template <typename T>
struct Args {
  const T* x;   // (n,3)
  T* u;         // (9,E), the output u' (in: a copy of u)
  T* warm;      // (3,E), the output warm'
  T* au;        // (n,3), the output au'
  T* cu;        // (n,3), the output cu'
  T* rows;      // (12,E)
  const int* __restrict__ idx;
  const T* __restrict__ cp;
  const T* __restrict__ w2;
  const T* __restrict__ mu;
  const T* __restrict__ lam;
  const T* __restrict__ kp;
  const T* __restrict__ aw2;
  const T* __restrict__ ancz;
  const int* __restrict__ inc;
  const T* __restrict__ u_in;
  const T* __restrict__ warm_in;
  const T* __restrict__ au_in;
  const T* __restrict__ cu_in;
  T* b;         // (n,3)
  // collect: the primal residual's block partials (eb + vb), the element
  // blocks' then the vertex blocks'
  T* part;
  int eb;
  int n, E, S, n_shapes, newton_iters;
  T sc[N_SCALARS];
  int shape_kind[MAX_SHAPES];
  T shape_prm[MAX_SHAPES][SHAPE_PRM];
};

template <typename T, int MODEL, int COLLECT>
__global__ void __launch_bounds__(THREADS) element_kernel(const Args<T> a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  T r2 = T(0);
  if (e < a.E) {
    const size_t sE = static_cast<size_t>(a.E);
#pragma unroll
    for (int q = 0; q < 9; ++q) a.u[q * sE + e] = a.u_in[q * sE + e];
#pragma unroll
    for (int q = 0; q < 3; ++q) a.warm[q * sE + e] = a.warm_in[q * sE + e];
    r2 = banded::element_step<T, MODEL, COLLECT>(a, e);
  }
  if constexpr (COLLECT != residuals::NONE)
    residuals::block_partial(r2, a.part + blockIdx.x);
}

template <typename T, int COLLECT>
__global__ void __launch_bounds__(THREADS) vertex_kernel(const Args<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  T r2 = T(0);
  if (i < a.n) {
    const size_t q = 3 * static_cast<size_t>(i);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.au[q + c] = a.au_in[q + c];
      a.cu[q + c] = a.cu_in[q + c];
    }
    T b[3];
    r2 = banded::vertex_rhs<T, COLLECT>(a, i, b);
#pragma unroll
    for (int c = 0; c < 3; ++c) a.b[q + c] = b[c];
  }
  if constexpr (COLLECT != residuals::NONE)
    residuals::block_partial(r2, a.part + a.eb + blockIdx.x);
}

template <typename T, int COLLECT>
void* element_kernel_of(int model) {
  return model == 0   ? (void*)element_kernel<T, 0, COLLECT>
         : model == 1 ? (void*)element_kernel<T, 1, COLLECT>
                      : (void*)element_kernel<T, 2, COLLECT>;
}

template <typename T>
int launch(const T* x, const T* au, const T* cu, const T* u, const T* warm,
           const int* idx, const T* cp, const T* w2, const T* mu,
           const T* lam, const T* kp, const T* aw2, const T* ancz,
           const int* inc, T* b, T* au_out, T* cu_out, T* u_out,
           T* warm_out, T* rows, T* part, T* r2, const int* shape_kinds,
           const double* shape_prm, const double* scalars, int n, int E,
           int S, int n_shapes, int model, int newton_iters, int collect,
           void* stream) {
  if (n < 1 || E < 1 || S < 1 || n_shapes < 0 || n_shapes > MAX_SHAPES ||
      model < 0 || model > 2 || newton_iters < 0 ||
      (collect != 0 && (part == nullptr || r2 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a{};
  a.x = x; a.u = u_out; a.warm = warm_out; a.au = au_out; a.cu = cu_out;
  a.rows = rows; a.idx = idx; a.cp = cp; a.w2 = w2; a.mu = mu; a.lam = lam;
  a.kp = kp; a.aw2 = aw2; a.ancz = ancz; a.inc = inc; a.u_in = u;
  a.warm_in = warm; a.au_in = au; a.cu_in = cu; a.b = b; a.part = part;
  a.n = n; a.E = E; a.S = S; a.n_shapes = n_shapes;
  a.newton_iters = newton_iters;
  for (int q = 0; q < N_SCALARS; ++q) a.sc[q] = static_cast<T>(scalars[q]);
  for (int q = 0; q < n_shapes; ++q) {
    a.shape_kind[q] = shape_kinds[q];
    for (int j = 0; j < SHAPE_PRM; ++j)
      a.shape_prm[q][j] = static_cast<T>(shape_prm[q * SHAPE_PRM + j]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int eb = (E + THREADS - 1) / THREADS, vb = (n + THREADS - 1) / THREADS;
  a.eb = eb;
  void* kargs[] = {&a};
  cudaError_t err = cudaLaunchKernel(
      collect ? element_kernel_of<T, residuals::PRIMAL>(model)
              : element_kernel_of<T, residuals::NONE>(model),
      dim3(eb), dim3(THREADS), kargs, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaLaunchKernel(
        collect ? (void*)vertex_kernel<T, residuals::PRIMAL>
                : (void*)vertex_kernel<T, residuals::NONE>,
        dim3(vb), dim3(THREADS), kargs, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && collect) {
    residuals::finalize_kernel<T><<<1, THREADS, 0, s>>>(
        part, eb + vb, nullptr, 0, 1, T(0), 1, r2, nullptr, 0, 0, 0);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace banded_local
}  // namespace admm

#define ADMM_BANDED_LOCAL_ENTRY(T, SUFFIX)                                    \
  int banded_local_rhs_##SUFFIX(                                              \
      const T* x, const T* au, const T* cu, const T* u, const T* warm,        \
      const int* idx, const T* cp, const T* w2, const T* mu, const T* lam,    \
      const T* kp, const T* aw2, const T* ancz, const int* inc, T* b,         \
      T* au_out, T* cu_out, T* u_out, T* warm_out, T* rows, T* part, T* r2,   \
      const int* shape_kinds, const double* shape_prm,                        \
      const double* scalars, int n, int E, int S, int n_shapes, int model,    \
      int newton_iters, int collect, void* stream) {                          \
    return admm::banded_local::launch<T>(                                     \
        x, au, cu, u, warm, idx, cp, w2, mu, lam, kp, aw2, ancz, inc, b,      \
        au_out, cu_out, u_out, warm_out, rows, part, r2, shape_kinds,         \
        shape_prm, scalars, n, E, S, n_shapes, model, newton_iters, collect,  \
        stream);                                                              \
  }

extern "C" {

// model: 0 = NeoHookean, 1 = StVK, 2 = ARAP (mu, lam and newton_iters
// unused). x, au, cu, u, warm are read; b, au_out, cu_out, u_out,
// warm_out are written, rows (12,E) is scratch. shape_kinds, shape_prm
// (n_shapes x 5) and scalars (7, banded_step.cu's; the collision
// weight^2 is read) are host arrays. collect: 1 also writes the squared
// primal residual to r2 (one value), part (eb + vb) its scratch; 0
// neither (both may be null). Returns the cudaError_t of the launches, or
// 0.
ADMM_BANDED_LOCAL_ENTRY(float, f32)
ADMM_BANDED_LOCAL_ENTRY(double, f64)

}  // extern "C"
