// Whole ADMM timesteps of a tet mesh as a window of plain launches and
// cluster solves, for Hopper.
//
// Replaces: admm_elastic_tpu/ops/pallas/banded_step.py, _banded_call
// (kernel _make_banded_kernel), with model nh, stvk or arap and A_hat as
// diagonals (dia mode) or as ELL rows (its uell mode: a tet mesh of any
// topology): explicit gravity kick, every ADMM iteration's hyperelastic or
// corotational local steps, dual updates, anchor and collision
// projections, right-hand side, and a whole fixed-budget PCG solve, for
// n_steps timesteps per call; its preconditioner Jacobi, or in the dia
// mode the in-kernel geometric multigrid V-cycle (mg_meta,
// banded_step.py:600-739 and :924-951), in the ELL mode the in-kernel
// algebraic one (uamg_meta, :741-888 and :924-955); both mg_vcycle.cuh,
// the geometric one in its compact level form.
//
// Layout, with no padding and no lane packing: vertex arrays (n,3)
// row-major; element planes (P,E) in the tet force's own element order;
// the element->vertex map idx (4,E); the vertex->(element,corner) incidence
// inc (n,S), row-major, whose slots hold 4e+k in ascending order and then a
// sentinel >= 4E (core/solver.assemble_transpose_incidence). The matrix:
// dia (D,n) at offsets offs, or the ELL arrays slot-major, (K,n) each
// (cg_ell.cu); the Pallas kernel's uell slot and fold planes, lane
// dilution and hub splits are TPU layout and are not carried over.
//
// One timestep, each line a launch on the caller's stream, in order:
//   kick, per vertex (window.cuh): v += dt g where m > 0; x_pre = x;
//     x += dt v; M xbar = m x
//   admm_iters times:
//     element kernel, one thread per element: F = u + sum_k cp x[idx_k],
//       oriented SVD; nh/stvk: warm-start guards, Newton prox, warm';
//       arap: z = (k U diag(1,1,+-1) V^T + w2 F) / (w2 + k); u' = F - z,
//       rows[3k+a] = sum_b cp[4b+k] w2 (F - 2u')[3a+b]
//     vertex kernel, one thread per vertex: b = its incidence rows summed
//       in slot order (fixed order, no atomics); anchor dual (zero where
//       the anchor weight is 0) and its RHS; collision shapes projected
//       in declaration order, dual and RHS; rhs = M xbar + dt^2 b
//     the cluster solve of A x = rhs from x, in place (cg_dia.cu or
//       cg_ell.cu on cluster_pcg.cuh, D^-1 = invd as given): it forms
//       r = rhs - A x itself, then cg_iters iterations on one 16-CTA
//       cluster; under the multigrid, cg_dia.cu's geometric or (ELL)
//       cg_ell.cu's algebraic multigrid mode (mg_vcycle.cuh), the V-cycle
//       in place of D^-1
//   end, per vertex: v = (x - x_pre) (1/dt)
// With residual collection (collect, banded_step.py:152-157, 187-190,
// 270-275, 390-441, 464-466, 509-520, 890-915; residuals.cuh), the element
// and vertex kernels are their PRIMAL or FULL instantiations, which also
// write each block's partial of the squared primal residual (and under
// FULL the dual residual's rows zrows, its vertex sums T z and their
// partials); FULL opens a timestep with two more launches, the seed T
// z_prev = the incidence sum of w2 D^T D x_pre rows + aw2 x_pre (+ cw2
// x_pre), and every collecting timestep ends with finalize_kernel, which
// writes its admm_iters residuals. Collecting only reads the state: x and
// every dual are the same bits with it on or off.
// The arithmetic follows the Pallas kernel's evaluation order; the plain
// PyTorch twin (ops/kernels/banded_step.py) follows the same order, its
// solve the cluster solve's (core/solver.pcg_fixed_inv with
// cg_step.cluster_dot). The element and vertex phases (element_step,
// vertex_rhs) live in banded_phases.cuh, shared with the sharded
// stepper's local phase (banded_local.cu).
//
// What bounds it on this card: at the 100k-tet beam (E = 100,000, n =
// 22,386, 19 diagonals) the whole working set is ~24 MB in f32 and ~45 MB
// in f64, both L2-resident (50 MB), so device memory is not the limit; at
// delaunay100k (E = 100,852, n = 16,280, K = 32) it is ~27 MB in f32. The
// element phase is ALU- and latency-bound (a few thousand dependent flops
// per element, as nh_local.cu) and wants the whole card; the solve is a
// chain of short dependent iterations that one cluster runs without a
// grid barrier (cluster_pcg.cuh: ~8.6 us an iteration at tet100k, where
// the cooperative kernel this replaces paid three grid barriers, ~14.7
// us).
//
// Design: 2 + 3 admm_iters plain launches a timestep, from one host call a
// window; the caller captures a window in a CUDA graph once and replays
// it (ops/kernels/banded_step.py), so a window is one submission. The
// state is advanced in place; no kernel reads, through a const
// __restrict__ pointer, a buffer that it writes.
//
// Scenario sweep (the Pallas kernel's sweep mode, n_scen, banded_step.py:
// 200-234, 1048-1064; core/sweep.py): n_scen > 1 independent simulations
// of one mesh in the same launches. Each kernel takes its scenario from
// blockIdx.y (the finalize kernel from blockIdx.x), the cluster solve one
// 16-CTA cluster a scenario (cluster_pcg.cuh, Scenarios). Per scenario, at
// a stride of one scenario's size: the state x, v, au, cu (n,3), u (9,E),
// warm (3,E); the planes w2, mu, lam, k (E,), invd, aw2 (n,), dia (D,n) or
// the slot-major ELL values (K,n); the scratch and residual partials.
// Shared: idx, cp, mass, ancz, inc and the ELL indices. A timestep is the
// same 2 + 3 admm_iters launches whatever n_scen is, and every scenario
// runs the single program's arithmetic in its order: a scenario's bits are
// those of the single window fed its planes.

#include "banded_phases.cuh"
#include "dia.cuh"
#include "window.cuh"

namespace admm {
namespace banded {

using window::THREADS;

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
  const T* __restrict__ aw2;
  const T* __restrict__ ancz;   // (n,3)
  const int* __restrict__ inc;  // (n,S)
  // scratch
  T* xpre;
  T* mxbar;
  T* rows;  // (12,E)
  T* rhs;   // (n,3)
  // residual collection: the dual residual's rows (12,E) and T z (n,3);
  // the partials of ADMM iteration `it`: primal part[it * (eb + vb) +
  // block] (the element blocks', then the vertex blocks'), dual
  // dpart[it * vb + block]
  T* zrows;
  T* tz;
  T* part;
  T* dpart;
  int it, eb, vb, iters;
  int n, E, S, n_shapes, newton_iters;
  T sc[N_SCALARS];
  int shape_kind[MAX_SHAPES];
  T shape_prm[MAX_SHAPES][SHAPE_PRM];
};

static_assert(THREADS == residuals::THREADS, "one block size");

// Scenario blockIdx.y's view of Args: the fields banded_phases.cuh reads,
// the per-scenario ones at their scenario's offset (0 for one scenario).
template <typename T>
struct Scenario {
  T* x;
  T* u;
  T* warm;
  T* au;
  T* cu;
  const int* __restrict__ idx;
  const T* __restrict__ cp;
  const T* __restrict__ w2;
  const T* __restrict__ mu;
  const T* __restrict__ lam;
  const T* __restrict__ kp;
  const T* __restrict__ aw2;
  const T* __restrict__ ancz;
  const int* __restrict__ inc;
  T* xpre;
  T* mxbar;
  T* rows;
  T* rhs;
  T* zrows;
  T* tz;
  int E, S, n_shapes, newton_iters;
  const T* sc;
  const int* shape_kind;
  const T (*shape_prm)[SHAPE_PRM];
};

template <typename T>
__device__ __forceinline__ Scenario<T> scenario(const Args<T>& a) {
  const size_t s = blockIdx.y, n = s * a.n, E = s * a.E;
  return {a.x + 3 * n,       a.u + 9 * E,      a.warm + 3 * E,
          a.au + 3 * n,      a.cu + 3 * n,     a.idx,
          a.cp,              a.w2 + E,         a.mu + E,
          a.lam + E,         a.kp + E,         a.aw2 + n,
          a.ancz,            a.inc,            a.xpre + 3 * n,
          a.mxbar + 3 * n,   a.rows + 12 * E,  a.rhs + 3 * n,
          a.zrows == nullptr ? nullptr : a.zrows + 12 * E,
          a.tz == nullptr ? nullptr : a.tz + 3 * n,
          a.E,               a.S,              a.n_shapes,
          a.newton_iters,    a.sc,             a.shape_kind,
          a.shape_prm};
}

// Scenario blockIdx.y's primal partials of ADMM iteration a.it (its
// element blocks', then its vertex blocks'), and its dual partials.
template <typename T>
__device__ __forceinline__ T* partials(const Args<T>& a) {
  return a.part + (static_cast<size_t>(blockIdx.y) * a.iters + a.it) *
                      (a.eb + a.vb);
}

template <typename T>
__device__ __forceinline__ T* dual_partials(const Args<T>& a) {
  return a.dpart + (static_cast<size_t>(blockIdx.y) * a.iters + a.it) * a.vb;
}

template <typename T, int MODEL, int COLLECT>
__global__ void __launch_bounds__(THREADS)
    element_kernel(const __grid_constant__ Args<T> a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const Scenario<T> s = scenario(a);
  if constexpr (COLLECT == residuals::NONE) {
    if (e < a.E) element_step<T, MODEL>(s, e);
  } else {
    const T r2 = e < a.E ? element_step<T, MODEL, COLLECT>(s, e) : T(0);
    residuals::block_partial(r2, partials(a) + blockIdx.x);
  }
}

// Vertex i: RHS, anchor and collision duals (vertex_rhs), then rhs = M
// xbar + dt^2 b.
template <typename T, int COLLECT>
__global__ void __launch_bounds__(THREADS)
    vertex_kernel(const __grid_constant__ Args<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Scenario<T> s = scenario(a);
  T b[3], r2 = T(0), d2 = T(0);
  if (i < a.n) {
    r2 = vertex_rhs<T, COLLECT>(s, i, b, &d2);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const size_t q = 3 * static_cast<size_t>(i) + c;
      s.rhs[q] = s.mxbar[q] + a.sc[DT2] * b[c];
    }
  }
  if constexpr (COLLECT != residuals::NONE)
    residuals::block_partial(r2, partials(a) + a.eb + blockIdx.x);
  if constexpr (COLLECT == residuals::FULL)
    residuals::block_partial(d2, dual_partials(a) + blockIdx.x);
}

// The dual residual's seed (FULL): the rows of w2 D^T D x_pre, then per
// vertex T z_prev.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    seed_element_kernel(const __grid_constant__ Args<T> a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < a.E) seed_rows<T>(scenario(a), e);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    seed_vertex_kernel(const __grid_constant__ Args<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) seed_vertex<T>(scenario(a), i);
}

template <typename T, int COLLECT>
void* element_kernel_of(int model) {
  return model == 0   ? (void*)element_kernel<T, 0, COLLECT>
         : model == 1 ? (void*)element_kernel<T, 1, COLLECT>
                      : (void*)element_kernel<T, 2, COLLECT>;
}

template <typename T>
void* element_kernel_of(int model, int collect) {
  return collect == residuals::NONE
             ? element_kernel_of<T, residuals::NONE>(model)
         : collect == residuals::PRIMAL
             ? element_kernel_of<T, residuals::PRIMAL>(model)
             : element_kernel_of<T, residuals::FULL>(model);
}

template <typename T>
void* vertex_kernel_of(int collect) {
  return collect == residuals::NONE     ? (void*)vertex_kernel<T, 0>
         : collect == residuals::PRIMAL ? (void*)vertex_kernel<T, 1>
                                        : (void*)vertex_kernel<T, 2>;
}

template <typename T>
int launch(T* x, T* v, T* u, T* warm, T* au, T* cu, const int* idx,
           const T* cp, const T* w2, const T* mu, const T* lam, const T* kp,
           const T* mass, const T* invd, const T* aw2, const T* ancz,
           const int* inc, const T* dia_vals, const int* ell_idx_t,
           const T* ell_vals_t, T* xpre, T* mxbar, T* rows, T* rhs,
           T* scratch, T* zrows, T* tz, T* part, T* dpart, T* res_p,
           T* res_d, const int* offsets, const int* shape_kinds,
           const double* shape_prm, const double* scalars, const void* mg,
           int n, int E,
           int D, int K, int H, int S, int n_shapes, int model,
           int newton_iters, int cg_iters, int admm_iters, int n_steps,
           int collect, int n_scen, void* stream) {
  // exactly one matrix: D diagonals (K = 0) or K ELL slots (D = 0)
  const bool matrix_ok =
      K > 0 ? (D == 0 && ell_idx_t != nullptr && ell_vals_t != nullptr)
            : (D >= 1 && D <= dia::MAX_DIAGONALS && dia_vals != nullptr);
  if (n < 1 || E < 1 || !matrix_ok || K < 0 || H < 0 || S < 1 ||
      n_shapes < 0 || n_shapes > MAX_SHAPES || model < 0 || model > 2 ||
      newton_iters < 0 || cg_iters < 0 || admm_iters < 0 || n_steps < 0 ||
      n_scen < 1 || n_scen > 65535 || (mg != nullptr && n_scen != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // what each residual mode writes
  if (collect < residuals::NONE || collect > residuals::FULL ||
      (collect != residuals::NONE && (part == nullptr || res_p == nullptr)) ||
      (collect == residuals::FULL &&
       (zrows == nullptr || tz == nullptr || dpart == nullptr ||
        res_d == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a{};
  a.x = x; a.v = v; a.u = u; a.warm = warm; a.au = au; a.cu = cu;
  a.idx = idx; a.cp = cp; a.w2 = w2; a.mu = mu; a.lam = lam; a.kp = kp;
  a.aw2 = aw2; a.ancz = ancz; a.inc = inc;
  a.xpre = xpre; a.mxbar = mxbar; a.rows = rows; a.rhs = rhs;
  a.zrows = zrows; a.tz = tz; a.part = part; a.dpart = dpart;
  a.n = n; a.E = E; a.S = S; a.n_shapes = n_shapes; a.iters = admm_iters;
  a.newton_iters = newton_iters;
  for (int q = 0; q < N_SCALARS; ++q) a.sc[q] = static_cast<T>(scalars[q]);
  for (int q = 0; q < n_shapes; ++q) {
    a.shape_kind[q] = shape_kinds[q];
    for (int j = 0; j < SHAPE_PRM; ++j)
      a.shape_prm[q][j] = static_cast<T>(shape_prm[q * SHAPE_PRM + j]);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // y: the scenario
  const dim3 vb(window::blocks_for(n).x, n_scen),
      eb(window::blocks_for(E).x, n_scen);
  a.eb = static_cast<int>(eb.x);
  a.vb = static_cast<int>(vb.x);
  // each launch takes a copy of a: `it` is set before the ADMM
  // iteration's launches
  void* kargs[] = {&a};
  void* element = element_kernel_of<T>(model, collect);
  void* vertex = vertex_kernel_of<T>(collect);
  window::clear_errors();
  for (int step = 0; step < n_steps; ++step) {
    window::kick_kernel<T><<<vb, THREADS, 0, st>>>(
        x, v, xpre, mxbar, mass, a.sc[DT], a.sc[DTG0], a.sc[DTG1],
        a.sc[DTG2], n);
    int err = window::launched();
    if (err == 0 && collect == residuals::FULL) {
      err = static_cast<int>(cudaLaunchKernel(
          (void*)seed_element_kernel<T>, eb, dim3(THREADS), kargs, 0, st));
      if (err == 0)
        err = static_cast<int>(cudaLaunchKernel(
            (void*)seed_vertex_kernel<T>, vb, dim3(THREADS), kargs, 0, st));
    }
    for (int it = 0; it < admm_iters && err == 0; ++it) {
      a.it = it;
      err = static_cast<int>(
          cudaLaunchKernel(element, eb, dim3(THREADS), kargs, 0, st));
      if (err == 0)
        err = static_cast<int>(
            cudaLaunchKernel(vertex, vb, dim3(THREADS), kargs, 0, st));
      if (err == 0)
        err = mg == nullptr
                  ? window::solve(rhs, x, invd, dia_vals, offsets, D,
                                  ell_idx_t, ell_vals_t, K, H, n, cg_iters,
                                  scratch, st, n_scen)
              : K > 0 ? window::uamg_solve(rhs, x, ell_idx_t, ell_vals_t, K,
                                           n, cg_iters, mg, scratch, st)
                      : window::mg_solve(rhs, x, dia_vals, offsets, D, n,
                                         cg_iters, mg, scratch, st);
    }
    if (err != 0) return window::failed(err);
    window::end_kernel<T><<<vb, THREADS, 0, st>>>(x, v, xpre, a.sc[INV_DT],
                                                 n);
    err = window::launched();
    if (err == 0 && collect != residuals::NONE) {
      const size_t at = static_cast<size_t>(step) * admm_iters,
                   iters = admm_iters;
      const bool full = collect == residuals::FULL;
      // one block a scenario; scenario s's residuals n_steps admm_iters on
      residuals::finalize_kernel<T><<<n_scen, THREADS, 0, st>>>(
          part, a.eb + a.vb, full ? dpart : nullptr, a.vb, admm_iters,
          a.sc[DT2], 0, res_p + at, full ? res_d + at : nullptr,
          iters * (a.eb + a.vb), iters * a.vb, iters * n_steps);
      err = window::launched();
    }
    if (err != 0) return window::failed(err);
  }
  return 0;
}

}  // namespace banded
}  // namespace admm

#define ADMM_BANDED_ENTRY(T, SUFFIX)                                          \
  int banded_rollout_##SUFFIX(                                                \
      T* x, T* v, T* u, T* warm, T* au, T* cu, const int* idx, const T* cp,   \
      const T* w2, const T* mu, const T* lam, const T* kp, const T* mass,     \
      const T* invd, const T* aw2, const T* ancz, const int* inc,             \
      const T* dia_vals, const int* ell_idx_t, const T* ell_vals_t, T* xpre,  \
      T* mxbar, T* rows, T* rhs, T* scratch, T* zrows, T* tz, T* part,        \
      T* dpart, T* res_p, T* res_d, const int* offsets,                       \
      const int* shape_kinds, const double* shape_prm, const double* scalars, \
      const void* mg, int n, int E, int D, int K, int H, int S, int n_shapes, \
      int model, int newton_iters, int cg_iters, int admm_iters, int n_steps, \
      int collect, int n_scen, void* stream) {                                \
    return admm::banded::launch<T>(                                           \
        x, v, u, warm, au, cu, idx, cp, w2, mu, lam, kp, mass, invd, aw2,     \
        ancz, inc, dia_vals, ell_idx_t, ell_vals_t, xpre, mxbar, rows, rhs,   \
        scratch, zrows, tz, part, dpart, res_p, res_d, offsets, shape_kinds,  \
        shape_prm, scalars, mg, n, E, D, K, H, S, n_shapes, model,            \
        newton_iters, cg_iters, admm_iters, n_steps, collect, n_scen,         \
        stream);                                                              \
  }

extern "C" {

// model: 0 = NeoHookean, 1 = StVK, 2 = ARAP (mu, lam and newton_iters
// unused). The matrix is dia_vals at D offsets (K = 0, ELL pointers null)
// or the slot-major ell_idx_t/ell_vals_t (K,n) with K slots (D = 0,
// dia_vals null); H: how far a row reaches (the largest |offset|, or
// cg_ell's bandwidth). The state (x, v, u, warm, au, cu) is advanced
// n_steps timesteps in place; xpre, mxbar, rhs (n,3) and rows (12,E) are
// scratch, and scratch holds the cluster solve's global scratch
// (cg_cluster_plan; nullptr when it is 0). offsets, shape_kinds,
// shape_prm (n_shapes x 5) and scalars (7: dt, dt^2, 1/dt, dt g xyz,
// collision weight^2, formed in double) are host arrays. mg: null for the
// Jacobi-PCG solve, else the mg::Host (mg_vcycle.cuh) whose V-cycle
// preconditions it, on the dia rows (K = 0) or the ELL rows (K > 0);
// scratch then holds mg_solve_plan's count. collect: 0 none, 1 the primal residuals, 2 also
// the dual ones, written to res_p and res_d (n_steps, admm_iters); zrows
// (12,E), tz (n,3), part (admm_iters, eb + vb) and dpart (admm_iters, vb),
// with eb and vb the element and vertex blocks of 128 threads, are their
// scratch (null where the mode needs none). n_scen: the scenarios of a
// sweep (1: a single simulation; more: every per-scenario array above n_scen
// times over, one scenario after the other, the residuals (n_scen, n_steps,
// admm_iters); Jacobi only, mg null). Every launch
// goes to `stream` (a CUDA graph capture takes them all; the solve's
// set-up, cg_dia_prepare_* / cg_ell_prepare_* / mg_dia_prepare_* /
// uamg_ell_prepare_*, must run before). Returns
// the first nonzero cudaError_t of the launches, or 0.
ADMM_BANDED_ENTRY(float, f32)
ADMM_BANDED_ENTRY(double, f64)

}  // extern "C"
