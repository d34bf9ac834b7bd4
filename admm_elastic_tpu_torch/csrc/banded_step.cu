// Whole ADMM timesteps in one persistent cooperative kernel, for Hopper.
//
// Replaces: admm_elastic_tpu/ops/pallas/banded_step.py, _banded_call
// (kernel _make_banded_kernel), with model nh, stvk or arap and A_hat as
// diagonals (dia mode) or as ELL rows (its uell mode: a tet mesh of any
// topology): explicit gravity kick, every ADMM iteration's hyperelastic or
// corotational local steps, dual updates, anchor and collision projections, right-hand
// side, and a whole fixed-budget Jacobi-PCG solve, for n_steps timesteps
// per launch.
//
// Layout, with no padding and no lane packing: vertex arrays (n,3)
// row-major; element planes (P,E) in the tet force's own element order;
// the element->vertex map idx (4,E); the vertex->(element,corner) incidence
// inc (n,S), row-major, whose slots hold 4e+k in ascending order and then a
// sentinel >= 4E (core/solver.assemble_transpose_incidence). The matrix:
// dia (D,n) at offsets offs (dia.cuh), or ell_idx/ell_vals (n,K) row-major
// (ell.cuh); the Pallas kernel's uell slot and fold planes, lane dilution
// and hub splits are TPU layout and are not carried over.
//
// One timestep (barriers are grid-wide, cooperative_groups grid.sync()):
//   prologue, per vertex: v += dt g where m > 0; x_pre = x; x += dt v;
//     M xbar = m x                                                  barrier
//   admm_iters times:
//     element phase, one thread per element: F = u + sum_k cp x[idx_k],
//       oriented SVD; nh/stvk: warm-start guards, Newton prox, warm';
//       arap: z = (k U diag(1,1,+-1) V^T + w2 F) / (w2 + k); u' = F - z,
//       rows[3k+a] = sum_b cp[4b+k] w2 (F - 2u')[3a+b]            barrier
//     vertex phase, one thread per vertex: b = its incidence rows summed
//       in slot order (fixed order, no atomics); anchor dual (zero where
//       the anchor weight is 0) and its RHS; collision shapes projected
//       in declaration order, dual and RHS; r = M xbar + dt^2 b - A x;
//       p = D^-1 r; per-block partials of r.p                      barrier
//     cg_iters times (coop_pcg.cuh: the three stages of cg_dia.cu, the
//     barriers in place of its launches; every block sums the partials
//     itself in one fixed order, so all blocks hold the same scalars):
//       Ap = A p, partials of p.Ap                                  barrier
//       alpha = rz / pAp; x += alpha p; r -= alpha Ap; partials of
//       (r D^-1) r                                                  barrier
//       beta = rz' / rz; p = D^-1 r + beta p                        barrier
//   epilogue, per vertex: v = (x - x_pre) (1/dt)
// The arithmetic follows the Pallas kernel's evaluation order; the plain
// PyTorch twin (ops/kernels/banded_step.py) follows the same order. The
// element phase and the vertex phase's RHS (element_step, vertex_rhs) live
// in banded_phases.cuh, shared with the sharded stepper's local phase
// (banded_local.cu).
//
// What bounds it on this card: at the 100k-tet beam (E = 100,000, n =
// 22,386, 19 diagonals) the whole working set is ~24 MB in f32 and ~45 MB
// in f64, both L2-resident (50 MB), so device memory is not the limit; at
// delaunay100k (E = 100,852, n = 16,280, K = 32) it is ~27 MB in f32. The
// element phase is ALU- and latency-bound (a few thousand dependent flops
// per element, as nh_local.cu); the rest is the chain of 2 + 3k grid
// barriers per ADMM iteration (k = cg_iters), each costing a few
// microseconds, with a few microseconds of work between them.
//
// Design: one launch per rollout window, grid = SMs x the occupancy the
// register count allows (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// so every block is resident and grid.sync() is legal; a refused launch
// returns its cudaError_t. Every phase is a grid-stride loop, and a vertex
// keeps the same thread in every vertex phase, so the epilogue and the
// next prologue need no barrier between them. No thread returns early:
// every thread reaches every barrier. Buffers written during the launch
// are never read through the non-coherent (const __restrict__) path.
// ptxas registers and spills: printed by chip_smoke.py from the build log
// (see PERF.md).

#include <cooperative_groups.h>

#include "banded_phases.cuh"
#include "coop_pcg.cuh"
#include "ell.cuh"

namespace admm {
namespace banded {

namespace cgr = cooperative_groups;

constexpr int THREADS = 128;

template <typename T>
struct Args {
  // state, updated in place
  T* x;
  T* v;
  T* u;     // (9,E)
  T* warm;  // (3,E)
  T* au;    // anchor dual (n,3)
  T* cu;    // collision dual (n,3)
  // element planes
  const int* __restrict__ idx;  // (4,E)
  const T* __restrict__ cp;     // (12,E)
  const T* __restrict__ w2;
  const T* __restrict__ mu;
  const T* __restrict__ lam;
  const T* __restrict__ kp;
  // vertex planes
  const T* __restrict__ mass;
  const T* __restrict__ invd;
  const T* __restrict__ aw2;
  const T* __restrict__ ancz;   // (n,3)
  const T* __restrict__ dia;    // (D,n), dia mode
  const int* __restrict__ ell_idx;  // (n,K), ELL mode
  const T* __restrict__ ell_vals;   // (n,K), ELL mode
  const int* __restrict__ inc;  // (n,S)
  // scratch
  T* xpre;
  T* mxbar;
  T* rows;  // (12,E)
  T* r;
  T* p;
  T* ap;
  T* part;  // 2 * gridDim.x
  int n, E, D, K, S, n_shapes, newton_iters, cg_iters, admm_iters, n_steps;
  T sc[N_SCALARS];
  int shape_kind[MAX_SHAPES];
  T shape_prm[MAX_SHAPES][SHAPE_PRM];
  dia::Offsets offs;
};

// Vertex i: RHS, anchor and collision duals (vertex_rhs), r = M xbar +
// dt^2 b - A x and p = D^-1 r. Returns this vertex's share of r.p.
template <typename T, typename Row>
__device__ __forceinline__ T vertex_step(const Args<T>& a, const Row& row,
                                         int i) {
  const size_t si = static_cast<size_t>(i);
  T b[3];
  vertex_rhs(a, i, b);
  T ax[3];
  row(i, static_cast<const T*>(a.x), ax);
  const T invd = a.invd[i];
  T local = T(0);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T rr = a.mxbar[3 * si + c] + a.sc[DT2] * b[c] - ax[c];
    const T pp = invd * rr;
    a.r[3 * si + c] = rr;
    a.p[3 * si + c] = pp;
    local = local + rr * pp;
  }
  return local;
}

template <typename T, int MODEL, bool ELL>
__global__ void __launch_bounds__(THREADS) rollout_kernel(const Args<T> a) {
  cgr::grid_group grid = cgr::this_grid();
  __shared__ T sh[THREADS];
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gstride = gridDim.x * blockDim.x;
  const coop::PcgVecs<T> pcg_vecs{a.x, a.r, a.p, a.ap, a.invd, a.part, a.n};
  const auto row = [&a](int i, const T* y, T out[3]) {
    if constexpr (ELL)
      ell::ell_row(a.ell_idx, a.ell_vals, a.K, i, y, out);
    else
      dia::dia_row(a.dia, a.offs, a.D, a.n, i, y, out);
  };

  for (int step = 0; step < a.n_steps; ++step) {
    for (int i = gtid; i < a.n; i += gstride) {
      const T m = a.mass[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const size_t q = 3 * static_cast<size_t>(i) + c;
        const T vc = a.v[q] + (m > T(0) ? a.sc[DTG0 + c] : T(0));
        a.v[q] = vc;
        const T xs = a.x[q];
        a.xpre[q] = xs;
        const T xn = xs + a.sc[DT] * vc;
        a.x[q] = xn;
        a.mxbar[q] = m * xn;
      }
    }
    grid.sync();

    for (int it = 0; it < a.admm_iters; ++it) {
      for (int e = gtid; e < a.E; e += gstride) element_step<T, MODEL>(a, e);
      grid.sync();

      T local = T(0);
      for (int i = gtid; i < a.n; i += gstride)
        local = local + vertex_step(a, row, i);
      coop::pcg(grid, pcg_vecs, a.cg_iters, local, row, sh);
    }

    for (int i = gtid; i < a.n; i += gstride) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const size_t q = 3 * static_cast<size_t>(i) + c;
        a.v[q] = (a.x[q] - a.xpre[q]) * a.sc[INV_DT];
      }
    }
  }
}

template <typename T, bool ELL>
void* kernel_of(int model) {
  return model == 0   ? (void*)rollout_kernel<T, 0, ELL>
         : model == 1 ? (void*)rollout_kernel<T, 1, ELL>
                      : (void*)rollout_kernel<T, 2, ELL>;
}

template <typename T>
void* kernel_for(int model, int ell) {
  return ell ? kernel_of<T, true>(model) : kernel_of<T, false>(model);
}

// Blocks of the cooperative grid on the current device, or -cudaError_t.
template <typename T>
int grid_blocks(int model, int ell) {
  if (model < 0 || model > 2)
    return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_for<T>(model, ell), THREADS, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return sms * per_sm;
}

template <typename T>
int launch(T* x, T* v, T* u, T* warm, T* au, T* cu, const int* idx,
           const T* cp, const T* w2, const T* mu, const T* lam, const T* kp,
           const T* mass, const T* invd, const T* aw2, const T* ancz,
           const int* inc, const T* dia_vals, const int* ell_idx,
           const T* ell_vals, T* xpre, T* mxbar, T* rows, T* r, T* p, T* ap,
           T* part, const int* offsets, const int* shape_kinds,
           const double* shape_prm, const double* scalars, int n, int E,
           int D, int K, int S, int n_shapes, int model, int newton_iters,
           int cg_iters, int admm_iters, int n_steps, int part_len,
           void* stream) {
  // exactly one matrix: D diagonals (K = 0) or K ELL slots (D = 0)
  const int ell = K > 0;
  const bool matrix_ok =
      ell ? (D == 0 && ell_idx != nullptr && ell_vals != nullptr)
          : (D >= 1 && D <= dia::MAX_DIAGONALS && dia_vals != nullptr);
  if (n < 1 || E < 1 || !matrix_ok || K < 0 || S < 1 ||
      n_shapes < 0 || n_shapes > MAX_SHAPES || model < 0 || model > 2 ||
      newton_iters < 0 || cg_iters < 0 || admm_iters < 0 || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = grid_blocks<T>(model, ell);
  if (blocks < 0) return -blocks;
  if (part_len < 2 * blocks) return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a{};
  a.x = x; a.v = v; a.u = u; a.warm = warm; a.au = au; a.cu = cu;
  a.idx = idx; a.cp = cp; a.w2 = w2; a.mu = mu; a.lam = lam; a.kp = kp;
  a.mass = mass; a.invd = invd; a.aw2 = aw2; a.ancz = ancz;
  a.dia = dia_vals; a.ell_idx = ell_idx; a.ell_vals = ell_vals; a.inc = inc;
  a.xpre = xpre; a.mxbar = mxbar; a.rows = rows; a.r = r; a.p = p;
  a.ap = ap; a.part = part;
  a.n = n; a.E = E; a.D = D; a.K = K; a.S = S; a.n_shapes = n_shapes;
  a.newton_iters = newton_iters; a.cg_iters = cg_iters;
  a.admm_iters = admm_iters; a.n_steps = n_steps;
  for (int q = 0; q < N_SCALARS; ++q) a.sc[q] = static_cast<T>(scalars[q]);
  for (int q = 0; q < n_shapes; ++q) {
    a.shape_kind[q] = shape_kinds[q];
    for (int j = 0; j < SHAPE_PRM; ++j)
      a.shape_prm[q][j] = static_cast<T>(shape_prm[q * SHAPE_PRM + j]);
  }
  for (int d = 0; d < D; ++d) a.offs.v[d] = offsets[d];
  void* kargs[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel_for<T>(model, ell), dim3(blocks), dim3(THREADS), kargs, 0,
      static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace banded
}  // namespace admm

#define ADMM_BANDED_ENTRY(T, SUFFIX)                                          \
  int banded_rollout_##SUFFIX(                                                \
      T* x, T* v, T* u, T* warm, T* au, T* cu, const int* idx, const T* cp,   \
      const T* w2, const T* mu, const T* lam, const T* kp, const T* mass,     \
      const T* invd, const T* aw2, const T* ancz, const int* inc,             \
      const T* dia_vals, const int* ell_idx, const T* ell_vals, T* xpre,      \
      T* mxbar, T* rows, T* r, T* p, T* ap, T* part, const int* offsets,      \
      const int* shape_kinds, const double* shape_prm, const double* scalars, \
      int n, int E, int D, int K, int S, int n_shapes, int model,             \
      int newton_iters, int cg_iters, int admm_iters, int n_steps,            \
      int part_len, void* stream) {                                           \
    return admm::banded::launch<T>(                                           \
        x, v, u, warm, au, cu, idx, cp, w2, mu, lam, kp, mass, invd, aw2,     \
        ancz, inc, dia_vals, ell_idx, ell_vals, xpre, mxbar, rows, r, p, ap,  \
        part, offsets, shape_kinds, shape_prm, scalars, n, E, D, K, S,        \
        n_shapes, model, newton_iters, cg_iters, admm_iters, n_steps,         \
        part_len, stream);                                                    \
  }                                                                           \
  int banded_rollout_grid_##SUFFIX(int model, int ell) {                      \
    return admm::banded::grid_blocks<T>(model, ell);                          \
  }

extern "C" {

// model: 0 = NeoHookean, 1 = StVK, 2 = ARAP (mu, lam and newton_iters
// unused). The matrix is dia_vals at D offsets (K = 0, ELL pointers null)
// or ell_idx/ell_vals with K slots (D = 0, dia_vals null). The state (x,
// v, u, warm, au, cu) is advanced n_steps timesteps in place. offsets, shape_kinds, shape_prm
// (n_shapes x 5) and scalars (7: dt, dt^2, 1/dt, dt g xyz, collision
// weight^2, formed in double) are host arrays. part holds part_len >=
// 2 x banded_rollout_grid_*(model) values. Returns the cudaError_t of the
// launch, or 0.
ADMM_BANDED_ENTRY(float, f32)
ADMM_BANDED_ENTRY(double, f64)

}  // extern "C"
