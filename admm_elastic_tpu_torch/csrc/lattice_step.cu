// Whole ADMM timesteps on a uniform beam lattice as a window of plain
// launches and cluster solves, for Hopper.
//
// Replaces: admm_elastic_tpu/ops/pallas/lattice_step.py, _lattice_call
// (kernel _make_lattice_kernel): explicit gravity kick, every ADMM
// iteration's NeoHookean, StVK or ARAP local steps on the ten (parity,
// slot) tet groups of a make_beam_tets lattice, dual updates, the anchor
// dual, one optional Floor, right-hand side, and a whole fixed-budget
// Jacobi-PCG solve on A's diagonals, for n_steps timesteps per call.
//
// Layout, with no padding and no lane planes: vertex arrays (n,3)
// row-major in the lattice's canonical numbering; tet planes (P,E) in
// make_beam_tets order (tet e = 5 c + slot of valid cell c). Where the
// banded route reads idx (4,E) and an incidence table, these kernels do
// index arithmetic: a tet's cell (i, j, k) gives its parity, its group
// g = 5 parity + slot and its vertices base + off(corner); a vertex finds
// the tets it belongs to as (its (i, j, k) - the corner's (di, dj, dk)),
// kept when inside the cells and of the group's parity. The ten groups'
// selector coefficients, weights and corners are copied into shared memory
// by every block. The Pallas kernel's 128-lane padding, its (G,16,N) and
// (G,8,N) HBM dual tiles, the DMA streaming of u/warm and the lane shifts
// are TPU layout and are dropped; its phantom cells (i = nx, j = ny or
// k = nz, computed there and masked out of b) are not computed at all.
//
// One timestep, each line a launch on the caller's stream, in order:
//   kick, per vertex (window.cuh): v += dt g where m > 0; x_pre = x;
//     x += dt v; M xbar = m x
//   admm_iters times:
//     element kernel, one thread per tet of a valid cell:
//       F = u + sum_k cp_g[b,k] x[base + off_k] (zero coefficients
//       skipped), oriented SVD; nh/stvk: warm-start guards, Newton prox,
//       z = U sigma V^T; arap: z = (U diag(1,1,+-1) V^T + F)/2 (the
//       lattice kernel's own mix, lattice_step.py:251); u' = F - z;
//       rows[3k+j] = sum over cp_g[r,k] != 0 of cp_g[r,k] w2_g
//       (F - 2u')[3j+r]
//     vertex kernel, one thread per vertex: b = its rows in group-major,
//       corner-minor order (the Pallas kernel's accumulation; fixed
//       order, no atomics); anchor dual u' = (u + x) - z where the anchor
//       weight is > 0, else 0, and b += w2 (z - u'); the floor's
//       z = (x + u) with y raised to the floor, u' = (u + x) - z,
//       b += w2_floor (z - u'); rhs = M xbar + dt^2 b
//     the cluster solve of A x = rhs from x, in place, on the diagonals
//       (cg_dia.cu on cluster_pcg.cuh, D^-1 = invd as given)
//   end, per vertex: v = (x - x_pre) (1/dt)
// The plain PyTorch twin (ops/kernels/lattice_step.py) follows the same
// order of arithmetic, its solve the cluster solve's.
//
// What bounds it on this card: at the 100k-tet beam (E = 100,000, n =
// 22,386, 19 diagonals reaching 568 rows in the canonical numbering) the
// working set is ~20-25 MB in f32, L2-resident (50 MB), so device memory
// is not the limit; the element phase is ALU- and latency-bound (a few
// thousand dependent flops per tet), and the solve a chain of short
// iterations on one cluster, as in banded_step.cu.
//
// Design: banded_step.cu's. 2 + 3 admm_iters plain launches a timestep,
// from one host call a window, captured once in a CUDA graph by the
// caller and replayed (ops/kernels/lattice_step.py). The state is
// advanced in place. The model is a template parameter, the floor a flag.

#include "arap.cuh"
#include "dia.cuh"
#include "window.cuh"

namespace admm {
namespace lattice {

using window::THREADS;
constexpr int GROUPS = 10;
// scalars[]: dt, dt^2, 1/dt, dt g (3), floor y, floor weight^2, mu, lam,
// kprox
enum Scalar {
  DT = 0, DT2, INV_DT, DTG0, DTG1, DTG2, FLOOR_Y, FLOOR_W2, MU, LAM, KPROX,
  N_SCALARS
};

template <typename T>
struct Tables {
  T cp[GROUPS][12];  // entry 4b+k = cp[b,k] of the group's tet
  T w2[GROUPS];
  int corner[GROUPS][4];
};

template <typename T>
struct Args {
  // state, updated in place
  T* x;
  T* v;
  T* u;     // (9,E)
  T* warm;  // (3,E)
  T* au;    // anchor dual (n,3)
  T* cu;    // floor dual (n,3)
  // vertex planes
  const T* __restrict__ aw2;
  const T* __restrict__ ancz;  // (n,3)
  // scratch
  T* mxbar;
  T* rows;  // (12,E)
  T* rhs;   // (n,3)
  int nx, ny, nz, n, E, floor, newton_iters;
  T sc[N_SCALARS];
  Tables<T> tab;
};

// (di, dj, dk) of cell corner c: (0,0,0) (1,0,0) (1,1,0) (0,1,0), then the
// same at dk = 1
__device__ __forceinline__ int corner_di(int c) { return ((c + 1) >> 1) & 1; }
__device__ __forceinline__ int corner_dj(int c) { return (c >> 1) & 1; }
__device__ __forceinline__ int corner_dk(int c) { return c >> 2; }

// Tet e: local step, dual update and its 12 RHS rows.
template <typename T, int MODEL>
__device__ __forceinline__ void element_step(const Args<T>& a,
                                             const Tables<T>& tb, int e) {
  const size_t sE = static_cast<size_t>(a.E);
  const int slot = e % 5, cell = e / 5;
  const int nyz = a.ny * a.nz;
  const int i = cell / nyz, rem = cell - i * nyz;
  const int j = rem / a.nz, k = rem - j * a.nz;
  const int g = 5 * ((i + j + k) & 1) + slot;
  const int gy = a.ny + 1, gz = a.nz + 1;
  const int base = (i * gy + j) * gz + k;

  T c[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) c[q] = tb.cp[g][q];
  T xg[4][3];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int cc = tb.corner[g][kk];
    const size_t vtx = static_cast<size_t>(
        base + corner_di(cc) * gy * gz + corner_dj(cc) * gz + corner_dk(cc));
#pragma unroll
    for (int ia = 0; ia < 3; ++ia) xg[kk][ia] = a.x[3 * vtx + ia];
  }
  // f[3a+b] = u[3a+b] + sum_k cp[4b+k] x[vertex k, a], corner by corner
  T f[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) f[q] = a.u[q * sE + e];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int ia = 0; ia < 3; ++ia)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const T w = c[4 * b + kk];
        if (w != T(0)) f[3 * ia + b] = f[3 * ia + b] + w * xg[kk][ia];
      }

  T U[3][3], V[3][3], s[3];
  hyper::svd_columns<T>(f, Limits<T>::eps(), U, V, s);
  T z[9];
  if constexpr (MODEL == 2) {
    T P[9];
    arap::signed_projection<T>(U, V, s, P);
#pragma unroll
    for (int q = 0; q < 9; ++q) z[q] = T(0.5) * (P[q] + f[q]);
  } else {
    T w1 = a.warm[e], w2 = a.warm[sE + e], w3;
    hyper::warm_guard(w1, w2, a.warm[2 * sE + e], w3);
    hyper::newton_hyper<T, MODEL>(s, w1, w2, w3, a.sc[MU], a.sc[LAM],
                                  a.sc[KPROX], a.newton_iters);
    a.warm[e] = w1;
    a.warm[sE + e] = w2;
    a.warm[2 * sE + e] = w3;
    const T sig[3] = {w1, w2, w3};
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        z[3 * r + cc] = U[0][r] * sig[0] * V[0][cc] +
                        U[1][r] * sig[1] * V[1][cc] +
                        U[2][r] * sig[2] * V[2][cc];
  }

  const T w2g = tb.w2[g];
  T zu[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const T up = f[q] - z[q];
    a.u[q * sE + e] = up;
    zu[q] = w2g * (f[q] - T(2) * up);  // z - u' = F - 2u'
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
      T acc = T(0);
      bool started = false;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T w = c[4 * r + kk];
        if (w != T(0)) {
          const T t = w * zu[3 * jj + r];
          acc = started ? acc + t : t;
          started = true;
        }
      }
      a.rows[(3 * kk + jj) * sE + e] = acc;
    }
}

// Vertex i: RHS, anchor and floor duals, then rhs = M xbar + dt^2 b.
template <typename T>
__device__ __forceinline__ void vertex_step(const Args<T>& a,
                                            const Tables<T>& tb, int i) {
  const size_t si = static_cast<size_t>(i);
  const size_t sE = static_cast<size_t>(a.E);
  const int gy = a.ny + 1, gz = a.nz + 1;
  const int vi = i / (gy * gz), rem = i - vi * gy * gz;
  const int vj = rem / gz, vk = rem - vj * gz;
  T b[3] = {T(0), T(0), T(0)};
  for (int g = 0; g < GROUPS; ++g) {
    const int parity = g >= 5 ? 1 : 0;
    const int slot = g - 5 * parity;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int cc = tb.corner[g][kk];
      const int ci = vi - corner_di(cc), cj = vj - corner_dj(cc),
                ck = vk - corner_dk(cc);
      if (ci < 0 || ci >= a.nx || cj < 0 || cj >= a.ny || ck < 0 ||
          ck >= a.nz || ((ci + cj + ck) & 1) != parity)
        continue;
      const size_t e =
          static_cast<size_t>(5 * ((ci * a.ny + cj) * a.nz + ck) + slot);
#pragma unroll
      for (int c = 0; c < 3; ++c) b[c] = b[c] + a.rows[(3 * kk + c) * sE + e];
    }
  }
  const T aw2 = a.aw2[i];
  T xi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xi[c] = a.x[3 * si + c];
    const T anc = a.ancz[3 * si + c];
    // gated: a vertex with no anchor weight keeps a zero dual
    const T aun = aw2 > T(0) ? (a.au[3 * si + c] + xi[c]) - anc : T(0);
    a.au[3 * si + c] = aun;
    b[c] = b[c] + aw2 * (anc - aun);
  }
  if (a.floor) {
    T z[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) z[c] = xi[c] + a.cu[3 * si + c];
    z[1] = vmax(z[1], a.sc[FLOOR_Y]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T un = (a.cu[3 * si + c] + xi[c]) - z[c];
      a.cu[3 * si + c] = un;
      b[c] = b[c] + a.sc[FLOOR_W2] * (z[c] - un);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    a.rhs[3 * si + c] = a.mxbar[3 * si + c] + a.sc[DT2] * b[c];
}

// The group tables, into every block's shared memory.
template <typename T>
__device__ __forceinline__ void load_tables(const Tables<T>& src,
                                            Tables<T>& tb) {
  const T* from = &src.cp[0][0];
  T* to = &tb.cp[0][0];
  for (int q = threadIdx.x; q < GROUPS * 13; q += blockDim.x)
    to[q] = from[q];  // cp then w2, contiguous
  for (int q = threadIdx.x; q < GROUPS * 4; q += blockDim.x)
    (&tb.corner[0][0])[q] = (&src.corner[0][0])[q];
  __syncthreads();
}

template <typename T, int MODEL>
__global__ void __launch_bounds__(THREADS)
    element_kernel(const __grid_constant__ Args<T> a) {
  __shared__ Tables<T> tb;
  load_tables(a.tab, tb);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < a.E) element_step<T, MODEL>(a, tb, e);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    vertex_kernel(const __grid_constant__ Args<T> a) {
  __shared__ Tables<T> tb;
  load_tables(a.tab, tb);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) vertex_step(a, tb, i);
}

template <typename T>
void* element_kernel_of(int model) {
  return model == 0   ? (void*)element_kernel<T, 0>
         : model == 1 ? (void*)element_kernel<T, 1>
                      : (void*)element_kernel<T, 2>;
}

template <typename T>
int launch(T* x, T* v, T* u, T* warm, T* au, T* cu, const T* mass,
           const T* invd, const T* aw2, const T* ancz, const T* dia_vals,
           T* xpre, T* mxbar, T* rows, T* rhs, T* scratch,
           const int* offsets, const double* cp, const double* w2,
           const int* corner, const double* scalars, int nx, int ny, int nz,
           int D, int H, int model, int floor, int newton_iters,
           int cg_iters, int admm_iters, int n_steps, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || D < 1 || D > dia::MAX_DIAGONALS ||
      H < 0 || model < 0 || model > 2 || newton_iters < 0 || cg_iters < 0 ||
      admm_iters < 0 || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int q = 0; q < GROUPS * 4; ++q)
    if (corner[q] < 0 || corner[q] > 7)
      return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a{};
  a.x = x; a.v = v; a.u = u; a.warm = warm; a.au = au; a.cu = cu;
  a.aw2 = aw2; a.ancz = ancz; a.mxbar = mxbar; a.rows = rows; a.rhs = rhs;
  a.nx = nx; a.ny = ny; a.nz = nz;
  a.n = (nx + 1) * (ny + 1) * (nz + 1);
  a.E = 5 * nx * ny * nz;
  a.floor = floor != 0;
  a.newton_iters = newton_iters;
  for (int q = 0; q < N_SCALARS; ++q) a.sc[q] = static_cast<T>(scalars[q]);
  for (int g = 0; g < GROUPS; ++g) {
    for (int q = 0; q < 12; ++q)
      a.tab.cp[g][q] = static_cast<T>(cp[12 * g + q]);
    a.tab.w2[g] = static_cast<T>(w2[g]);
    for (int kk = 0; kk < 4; ++kk) a.tab.corner[g][kk] = corner[4 * g + kk];
  }
  const int n = a.n;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 vb = window::blocks_for(n), eb = window::blocks_for(a.E);
  void* kargs[] = {&a};
  void* element = element_kernel_of<T>(model);
  window::clear_errors();
  for (int step = 0; step < n_steps; ++step) {
    window::kick_kernel<T><<<vb, THREADS, 0, st>>>(
        x, v, xpre, mxbar, mass, a.sc[DT], a.sc[DTG0], a.sc[DTG1],
        a.sc[DTG2], n);
    int err = window::launched();
    for (int it = 0; it < admm_iters && err == 0; ++it) {
      err = static_cast<int>(
          cudaLaunchKernel(element, eb, dim3(THREADS), kargs, 0, st));
      if (err == 0)
        err = static_cast<int>(cudaLaunchKernel(
            (void*)vertex_kernel<T>, vb, dim3(THREADS), kargs, 0, st));
      if (err == 0)
        err = window::solve(rhs, x, invd, dia_vals, offsets, D, nullptr,
                            static_cast<const T*>(nullptr), 0, H, n,
                            cg_iters, scratch, st);
    }
    if (err != 0) return window::failed(err);
    window::end_kernel<T><<<vb, THREADS, 0, st>>>(x, v, xpre, a.sc[INV_DT],
                                                 n);
    err = window::launched();
    if (err != 0) return window::failed(err);
  }
  return 0;
}

}  // namespace lattice
}  // namespace admm

#define ADMM_LATTICE_ENTRY(T, SUFFIX)                                        \
  int lattice_rollout_##SUFFIX(                                              \
      T* x, T* v, T* u, T* warm, T* au, T* cu, const T* mass, const T* invd, \
      const T* aw2, const T* ancz, const T* dia_vals, T* xpre, T* mxbar,     \
      T* rows, T* rhs, T* scratch, const int* offsets, const double* cp,     \
      const double* w2, const int* corner, const double* scalars, int nx,    \
      int ny, int nz, int D, int H, int model, int floor, int newton_iters,  \
      int cg_iters, int admm_iters, int n_steps, void* stream) {             \
    return admm::lattice::launch<T>(                                         \
        x, v, u, warm, au, cu, mass, invd, aw2, ancz, dia_vals, xpre, mxbar, \
        rows, rhs, scratch, offsets, cp, w2, corner, scalars, nx, ny, nz, D, \
        H, model, floor, newton_iters, cg_iters, admm_iters, n_steps,        \
        stream);                                                             \
  }

extern "C" {

// model: 0 = NeoHookean, 1 = StVK, 2 = ARAP. The state (x, v, u, warm,
// au, cu) of an (nx, ny, nz)-cell lattice is advanced n_steps timesteps in
// place; xpre, mxbar, rhs (n,3) and rows (12,E) are scratch, and scratch
// holds the cluster solve's (cg_cluster_plan; nullptr when it is 0). H:
// the largest |offset|. offsets (D), cp (10 x 12), w2 (10), corner (10 x
// 4, cell corners 0..7) and scalars (11: dt, dt^2, 1/dt, dt g xyz, floor
// y, floor weight^2, mu, lam, kprox, formed in double) are host arrays.
// Every launch goes to `stream` (the solve's set-up, cg_dia_prepare_*,
// must run before a CUDA graph captures them). Returns the first nonzero
// cudaError_t of the launches, or 0.
ADMM_LATTICE_ENTRY(float, f32)
ADMM_LATTICE_ENTRY(double, f64)

}  // extern "C"
