// Whole ADMM timesteps in one persistent cooperative kernel, for Hopper.
//
// Replaces: admm_elastic_tpu/ops/pallas/banded_step.py, _banded_call
// (kernel _make_banded_kernel), in dia mode with model nh or stvk: explicit
// gravity kick, every ADMM iteration's hyperelastic local steps, dual
// updates, anchor and collision projections, right-hand side, and a whole
// fixed-budget Jacobi-PCG solve, for n_steps timesteps per launch.
//
// Layout, with no padding and no lane packing: vertex arrays (n,3)
// row-major; element planes (P,E) in the tet force's own element order;
// the element->vertex map idx (4,E); the vertex->(element,corner) incidence
// inc (n,S), row-major, whose slots hold 4e+k in ascending order and then a
// sentinel >= 4E (core/solver.assemble_transpose_incidence).
//
// One timestep (barriers are grid-wide, cooperative_groups grid.sync()):
//   prologue, per vertex: v += dt g where m > 0; x_pre = x; x += dt v;
//     M xbar = m x                                                  barrier
//   admm_iters times:
//     element phase, one thread per element: F = u + sum_k cp x[idx_k],
//       oriented SVD, warm-start guards, Newton prox, u' = F - z, warm',
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
// PyTorch twin (ops/kernels/banded_step.py) follows the same order.
//
// What bounds it on this card: at the 100k-tet beam (E = 100,000, n =
// 22,386, 19 diagonals) the whole working set is ~24 MB in f32 and ~45 MB
// in f64, both L2-resident (50 MB), so device memory is not the limit. The
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

#include "coop_pcg.cuh"
#include "hyper.cuh"

namespace admm {
namespace banded {

namespace cgr = cooperative_groups;

constexpr int THREADS = 128;
constexpr int MAX_SHAPES = 16;
constexpr int SHAPE_PRM = 5;
enum ShapeKind { FLOOR = 0, SPHERE = 1, CYLINDER = 2 };
// scalars[]: dt, dt^2, 1/dt, dt g (3), collision weight^2
enum Scalar { DT = 0, DT2, INV_DT, DTG0, DTG1, DTG2, COLL_W2, N_SCALARS };

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
  const T* __restrict__ dia;    // (D,n)
  const int* __restrict__ inc;  // (n,S)
  // scratch
  T* xpre;
  T* mxbar;
  T* rows;  // (12,E)
  T* r;
  T* p;
  T* ap;
  T* part;  // 2 * gridDim.x
  int n, E, D, S, n_shapes, newton_iters, cg_iters, admm_iters, n_steps;
  T sc[N_SCALARS];
  int shape_kind[MAX_SHAPES];
  T shape_prm[MAX_SHAPES][SHAPE_PRM];
  dia::Offsets offs;
};

// Element e: local step, dual update and its 12 RHS rows.
template <typename T, int MODEL>
__device__ __forceinline__ void element_step(const Args<T>& a, int e) {
  const size_t sE = static_cast<size_t>(a.E);
  T xg[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const size_t vtx = static_cast<size_t>(a.idx[k * sE + e]);
#pragma unroll
    for (int c = 0; c < 3; ++c) xg[k][c] = a.x[3 * vtx + c];
  }
  T c[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) c[q] = a.cp[q * sE + e];
  // f[3a+b] = u[3a+b] + sum_k cp[4b+k] x[idx_k, a]
  T f[9];
#pragma unroll
  for (int ia = 0; ia < 3; ++ia)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      T acc = a.u[(3 * ia + b) * sE + e];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = acc + c[4 * b + k] * xg[k][ia];
      f[3 * ia + b] = acc;
    }

  T U[3][3], V[3][3], s[3];
  hyper::svd_columns<T>(f, Limits<T>::eps(), U, V, s);
  T w1 = a.warm[e], w2 = a.warm[sE + e], w3;
  hyper::warm_guard(w1, w2, a.warm[2 * sE + e], w3);
  hyper::newton_hyper<T, MODEL>(s, w1, w2, w3, a.mu[e], a.lam[e], a.kp[e],
                                a.newton_iters);
  a.warm[e] = w1;
  a.warm[sE + e] = w2;
  a.warm[2 * sE + e] = w3;

  const T sig[3] = {w1, w2, w3};
  const T w2e = a.w2[e];
  T zu[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      const T z = U[0][r] * sig[0] * V[0][cc] + U[1][r] * sig[1] * V[1][cc] +
                  U[2][r] * sig[2] * V[2][cc];
      const T up = f[3 * r + cc] - z;
      a.u[(3 * r + cc) * sE + e] = up;
      // z - u' = F - 2u'
      zu[3 * r + cc] = w2e * (f[3 * r + cc] - T(2) * up);
    }
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T acc = c[k] * zu[3 * j];
      acc = acc + c[4 + k] * zu[3 * j + 1];
      acc = acc + c[8 + k] * zu[3 * j + 2];
      a.rows[(3 * k + j) * sE + e] = acc;
    }
}

// Collision shapes in declaration order (banded_step.py:478-503).
template <typename T>
__device__ __forceinline__ void project(const Args<T>& a, T z[3]) {
  for (int q = 0; q < a.n_shapes; ++q) {
    const T* pr = a.shape_prm[q];
    const int kind = a.shape_kind[q];
    if (kind == FLOOR) {
      z[1] = vmax(z[1], pr[0]);
    } else if (kind == SPHERE) {  // cx cy cz r r^2
      const T dx = z[0] - pr[0], dy = z[1] - pr[1], dz = z[2] - pr[2];
      const T d2 = dx * dx + dy * dy + dz * dz;
      const bool inside = d2 < pr[4];
      // at the exact center the huge rsqrt times a zero displacement
      // leaves the point where it is, as on the general path
      const T sc = pr[3] * rsqrt(vmax(d2, T(1e-30)));
      z[0] = inside ? pr[0] + dx * sc : z[0];
      z[1] = inside ? pr[1] + dy * sc : z[1];
      z[2] = inside ? pr[2] + dz * sc : z[2];
    } else {  // cylinder, axis parallel to z: cx cy r r^2
      const T dx = z[0] - pr[0], dy = z[1] - pr[1];
      const T d2 = dx * dx + dy * dy;
      const bool inside = d2 < pr[3];
      const T sc = pr[2] * rsqrt(vmax(d2, T(1e-30)));
      z[0] = inside ? pr[0] + dx * sc : z[0];
      z[1] = inside ? pr[1] + dy * sc : z[1];
    }
  }
}

// Vertex i: RHS, anchor and collision duals, r = M xbar + dt^2 b - A x and
// p = D^-1 r. Returns this vertex's share of r.p.
template <typename T>
__device__ __forceinline__ T vertex_step(const Args<T>& a, int i) {
  const size_t si = static_cast<size_t>(i);
  const int total = 4 * a.E;
  const size_t sE = static_cast<size_t>(a.E);
  T b[3] = {T(0), T(0), T(0)};
  for (int j = 0; j < a.S; ++j) {
    const int slot = a.inc[si * a.S + j];
    if (slot >= total) break;  // the sentinels follow the real slots
    const size_t e = static_cast<size_t>(slot >> 2);
    const int k = slot & 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) b[c] = b[c] + a.rows[(3 * k + c) * sE + e];
  }
  const T aw2 = a.aw2[i];
  T xi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xi[c] = a.x[3 * si + c];
    const T anc = a.ancz[3 * si + c];
    const T dlt = xi[c] - anc;
    // gated: a vertex with no anchor weight keeps a zero dual
    const T aun = aw2 > T(0) ? a.au[3 * si + c] + dlt : T(0);
    a.au[3 * si + c] = aun;
    b[c] = b[c] + aw2 * (anc - aun);
  }
  if (a.n_shapes > 0) {
    T z[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) z[c] = xi[c] + a.cu[3 * si + c];
    project(a, z);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T un = a.cu[3 * si + c] + (xi[c] - z[c]);
      a.cu[3 * si + c] = un;
      b[c] = b[c] + a.sc[COLL_W2] * (z[c] - un);
    }
  }
  T ax[3];
  dia::dia_row(a.dia, a.offs, a.D, a.n, i, static_cast<const T*>(a.x), ax);
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

template <typename T, int MODEL>
__global__ void __launch_bounds__(THREADS) rollout_kernel(const Args<T> a) {
  cgr::grid_group grid = cgr::this_grid();
  __shared__ T sh[THREADS];
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gstride = gridDim.x * blockDim.x;
  const coop::PcgVecs<T> pcg_vecs{a.x, a.r, a.p, a.ap, a.invd, a.part, a.n};
  const auto row = [&a](int i, const T* y, T out[3]) {
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
      for (int i = gtid; i < a.n; i += gstride) local = local + vertex_step(a, i);
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

template <typename T>
void* kernel_for(int model) {
  return model == 0 ? (void*)rollout_kernel<T, 0>
                    : (void*)rollout_kernel<T, 1>;
}

// Blocks of the cooperative grid on the current device, or -cudaError_t.
template <typename T>
int grid_blocks(int model) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_for<T>(model), THREADS, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return sms * per_sm;
}

template <typename T>
int launch(T* x, T* v, T* u, T* warm, T* au, T* cu, const int* idx,
           const T* cp, const T* w2, const T* mu, const T* lam, const T* kp,
           const T* mass, const T* invd, const T* aw2, const T* ancz,
           const T* dia_vals, const int* inc, T* xpre, T* mxbar, T* rows,
           T* r, T* p, T* ap, T* part, const int* offsets,
           const int* shape_kinds, const double* shape_prm,
           const double* scalars, int n, int E, int D, int S, int n_shapes,
           int model, int newton_iters, int cg_iters, int admm_iters,
           int n_steps, int part_len, void* stream) {
  if (n < 1 || E < 1 || D < 1 || D > dia::MAX_DIAGONALS || S < 1 ||
      n_shapes < 0 || n_shapes > MAX_SHAPES || (model != 0 && model != 1) ||
      newton_iters < 0 || cg_iters < 0 || admm_iters < 0 || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = grid_blocks<T>(model);
  if (blocks < 0) return -blocks;
  if (part_len < 2 * blocks) return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a{};
  a.x = x; a.v = v; a.u = u; a.warm = warm; a.au = au; a.cu = cu;
  a.idx = idx; a.cp = cp; a.w2 = w2; a.mu = mu; a.lam = lam; a.kp = kp;
  a.mass = mass; a.invd = invd; a.aw2 = aw2; a.ancz = ancz;
  a.dia = dia_vals; a.inc = inc;
  a.xpre = xpre; a.mxbar = mxbar; a.rows = rows; a.r = r; a.p = p;
  a.ap = ap; a.part = part;
  a.n = n; a.E = E; a.D = D; a.S = S; a.n_shapes = n_shapes;
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
      kernel_for<T>(model), dim3(blocks), dim3(THREADS), kargs, 0,
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
      const T* invd, const T* aw2, const T* ancz, const T* dia_vals,          \
      const int* inc, T* xpre, T* mxbar, T* rows, T* r, T* p, T* ap,          \
      T* part, const int* offsets, const int* shape_kinds,                    \
      const double* shape_prm, const double* scalars, int n, int E, int D,    \
      int S, int n_shapes, int model, int newton_iters, int cg_iters,         \
      int admm_iters, int n_steps, int part_len, void* stream) {              \
    return admm::banded::launch<T>(                                           \
        x, v, u, warm, au, cu, idx, cp, w2, mu, lam, kp, mass, invd, aw2,     \
        ancz, dia_vals, inc, xpre, mxbar, rows, r, p, ap, part, offsets,      \
        shape_kinds, shape_prm, scalars, n, E, D, S, n_shapes, model,         \
        newton_iters, cg_iters, admm_iters, n_steps, part_len, stream);       \
  }                                                                           \
  int banded_rollout_grid_##SUFFIX(int model) {                               \
    return admm::banded::grid_blocks<T>(model);                               \
  }

extern "C" {

// model: 0 = NeoHookean, 1 = StVK. The state (x, v, u, warm, au, cu) is
// advanced n_steps timesteps in place. offsets, shape_kinds, shape_prm
// (n_shapes x 5) and scalars (7: dt, dt^2, 1/dt, dt g xyz, collision
// weight^2, formed in double) are host arrays. part holds part_len >=
// 2 x banded_rollout_grid_*(model) values. Returns the cudaError_t of the
// launch, or 0.
ADMM_BANDED_ENTRY(float, f32)
ADMM_BANDED_ENTRY(double, f64)

}  // extern "C"
