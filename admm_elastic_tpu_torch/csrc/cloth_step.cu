// Whole cloth ADMM timesteps as a window of plain launches and cluster
// solves, for Hopper.
//
// Replaces: admm_elastic_tpu/ops/pallas/cloth_step.py, _cloth_call
// (kernel _make_cloth_kernel), with its in-kernel residuals: gravity
// and Wejchert-Haumann wind kicks, every ADMM iteration's triangle-strain
// and bend local steps, dual updates, the anchor dual and right-hand side,
// and a whole fixed-budget PCG solve, for n_steps timesteps per call; its
// preconditioner Jacobi or the in-kernel 2D geometric multigrid V-cycle
// (mg_meta, cloth_step.py:457-595 and :627-673; mg_vcycle.cuh).
//
// Layout, with no padding and no lane planes: vertex arrays (n,3)
// row-major; element planes (P,E), elements sorted by stencil group, each
// with its group id; the per-group constants in small tables (formed in
// double on the host, as the Pallas kernel bakes them); the vertex ->
// RHS-row incidence inc (n,S) in (group, corner) order with a sentinel
// >= R after the real slots, and the vertex -> wind-triangle incidence
// winc (n,Sw) with sentinel >= Ew (ops/kernels/cloth_step.py). The matrix
// is A's diagonals at their signed offsets, (D,n), the form the general
// route's dia solve takes; the Pallas kernel's symmetric half storage
// (offsets >= 0, each term mirrored) is TPU layout and is not kept.
//
// One timestep, each line a launch on the caller's stream, in order:
//   wind (when Ew > 0), per wind triangle: the drag from x and the
//     gravity-kicked v of its corners
//   kick, per vertex: v += dt g where m > 0, then its wind triangles'
//     forces in incidence order; x_pre = x; x += dt v; M xbar = m x
//   admm_iters times:
//     element kernel, one thread per triangle or hinge: F, the strain-
//       limited projection (tri.cuh) or the alpha-weighted flat projection
//       (cloth_step.py:340-420), u' = F - z, RHS rows w2 D^T (F - 2u')
//     vertex kernel, one thread per vertex: b = its incidence rows summed
//       in slot order (fixed order, no atomics); anchor dual (zero where
//       the anchor weight is 0) and RHS; rhs = M xbar + dt^2 b
//     the cluster solve of A x = rhs from x, in place (cg_dia.cu on
//       cluster_pcg.cuh, D^-1 = invd as given): it forms r = rhs - A x
//       itself, then cg_iters iterations on one 16-CTA cluster; under
//       the multigrid, cg_dia.cu's multigrid mode (mg_vcycle.cuh)
//   end, per vertex (window.cuh): v = (x - x_pre) (1/dt)
// With residual collection (collect, cloth_step.py:94-112, 219-221, 276,
// 304-326, 376-438, 597-612), as banded_step.cu: the element and vertex
// kernels' PRIMAL or FULL instantiations also write each block's partial
// of the squared primal residual (w2 ||u' - u||^2 per triangle and hinge,
// aw2 ||x - ancz||^2 per vertex) and under FULL the rows of w2 D^T z, T z
// = their incidence sum + aw2 ancz and the partials of ||T z - T
// z_prev||^2; FULL seeds T z_prev with w2 D^T D x_pre + aw2 x_pre (two
// launches after the kick), and each collecting timestep ends with
// residuals.cuh's finalize_kernel.
// The arithmetic of the local steps follows the Pallas kernel's
// evaluation order; the plain PyTorch twin (ops/kernels/cloth_step.py)
// follows the same order, its solve the cluster solve's
// (core/solver.pcg_fixed_inv with cg_step.cluster_dot).
//
// What bounds it on this card: at the cloth100k sheet (n = 51,076,
// 101,250 triangles, 151,425 hinges, 7 diagonals reaching 227 rows) the
// working set is ~35 MB in f32, L2-sized (50 MB), so device memory is not
// the limit; the element phase is a few hundred flops per element, and
// the solve a chain of short dependent iterations that one cluster runs
// without a grid barrier (the cooperative kernel this replaces paid three
// a CG iteration).
//
// Design: banded_step.cu's. 3 + 3 admm_iters plain launches a timestep
// (2 + 3 admm_iters without wind), from one host call a window; the
// caller captures a window in a CUDA graph once and replays it
// (ops/kernels/cloth_step.py), so a window is one submission. The state
// is advanced in place; no kernel reads, through a const __restrict__
// pointer, a buffer that it writes.

#include "dia.cuh"
#include "residuals.cuh"
#include "tri.cuh"
#include "window.cuh"

namespace admm {
namespace cloth {

using window::THREADS;
constexpr int TRI_TAB = 11;   // cp (6), w2, k, 1/(w2+k), lmin, lmax
constexpr int BEND_TAB = 10;  // arow (3), arow/2 (3), 2/|arow|^2, w2, k,
                              // 1/(w2+k)
// scalars[]: dt, dt^2, 1/dt, dt g (3), wind -alpha 0.33 dt, 1/3, wind (3)
enum Scalar {
  DT = 0, DT2, INV_DT, DTG0, DTG1, DTG2, WIND_C, THIRD, WD0, WD1, WD2,
  N_SCALARS
};

template <typename T>
struct Args {
  // state, updated in place
  T* x;
  T* v;
  T* tu;  // (6,Et)
  T* hu;  // (9,Eh)
  T* au;  // anchor dual (n,3)
  // element planes and group tables
  const int* __restrict__ tidx;  // (3,Et)
  const int* __restrict__ tgrp;  // (Et,)
  const T* __restrict__ ttab;    // (Gt, TRI_TAB)
  const int* __restrict__ hidx;  // (4,Eh)
  const int* __restrict__ hgrp;  // (Eh,)
  const T* __restrict__ htab;    // (Gb, BEND_TAB)
  const int* __restrict__ widx;  // (3,Ew)
  // vertex planes
  const T* __restrict__ mass;
  const T* __restrict__ aw2;
  const T* __restrict__ ancz;   // (n,3)
  const int* __restrict__ inc;  // (n,S)
  const int* __restrict__ winc; // (n,Sw)
  // scratch
  T* xpre;
  T* mxbar;
  T* rows;  // (3,R), R = 3 Et + 4 Eh
  T* wf;    // (3,Ew)
  T* rhs;   // (n,3)
  // residual collection: the dual residual's rows (3,R) and T z (n,3);
  // the partials of ADMM iteration `it`: primal part[it * (eb + vb) +
  // block] (the element blocks', then the vertex blocks'), dual
  // dpart[it * vb + block]
  T* zrows;
  T* tz;
  T* part;
  T* dpart;
  int it, eb, vb;
  int n, Et, Eh, Ew, S, Sw, limiting;
  T sc[N_SCALARS];
};

// Wind triangle w: the drag force shared by its 3 corners
// (cloth_step.py:159-204, ExplicitForce.cpp:42-98).
template <typename T>
__device__ __forceinline__ void wind_step(const Args<T>& a, int w) {
  const size_t sE = static_cast<size_t>(a.Ew);
  T px[3][3], vsum[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t vtx = static_cast<size_t>(a.widx[k * sE + w]);
    const T m = a.mass[vtx];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      px[k][c] = a.x[3 * vtx + c];
      const T vk = a.v[3 * vtx + c] + (m > T(0) ? a.sc[DTG0 + c] : T(0));
      vsum[c] = k == 0 ? vk : vsum[c] + vk;
    }
  }
  T e1[3], e2[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e1[c] = px[1][c] - px[0][c];
    e2[c] = px[2][c] - px[0][c];
  }
  const T nx = e1[1] * e2[2] - e1[2] * e2[1];
  const T ny = e1[2] * e2[0] - e1[0] * e2[2];
  const T nz = e1[0] * e2[1] - e1[1] * e2[0];
  const T nlen = sqrt(nx * nx + ny * ny + nz * nz);
  const T inv = T(1) / (nlen > T(0) ? nlen : T(1));
  const T nhat[3] = {nx * inv, ny * inv, nz * inv};
  const T area = T(0.5) * nlen;
  T v_n = T(0);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T term = nhat[c] * (vsum[c] * a.sc[THIRD] - a.sc[WD0 + c]);
    v_n = c == 0 ? term : v_n + term;
  }
  const T scale = a.sc[WIND_C] * area * v_n * fabs(v_n);
#pragma unroll
  for (int c = 0; c < 3; ++c) a.wf[c * sE + w] = scale * nhat[c];
}

// rows[j][k] of triangle t (at rows + j R + k Et + t) = cp[k] y[2j] +
// cp[3+k] y[2j+1], y already scaled by w2.
template <typename T>
__device__ __forceinline__ void tri_rows(const T* tab, const T y[6], T* rows,
                                         size_t R, size_t sE, int t) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      rows[j * R + k * sE + t] = tab[k] * y[2 * j] + tab[3 + k] * y[2 * j + 1];
}

// rows of hinge h (at rows + 3 Et + h): D^T columns, corner 0 += row 0,
// corner 1 += row 2, corner 2 -= all three rows, corner 3 += row 1.
template <typename T>
__device__ __forceinline__ void bend_rows(const T y[9], T* out, size_t R,
                                          size_t sE) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out[j * R] = y[j];
    out[j * R + sE] = y[6 + j];
    out[j * R + 2 * sE] = -((y[j] + y[3 + j]) + y[6 + j]);
    out[j * R + 3 * sE] = y[3 + j];
  }
}

// Triangle t: strain-limited local step, dual update, its 3 x 3 RHS rows.
// Returns its piece of the squared primal residual, w2 ||u' - u||^2 (0
// without COLLECT); under FULL also writes its rows of w2 D^T z.
template <typename T, int COLLECT>
__device__ __forceinline__ T tri_step(const Args<T>& a, int t) {
  const size_t sE = static_cast<size_t>(a.Et);
  const size_t R = 3 * sE + 4 * static_cast<size_t>(a.Eh);
  const T* tab = a.ttab + TRI_TAB * a.tgrp[t];
  T xg[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t vtx = static_cast<size_t>(a.tidx[k * sE + t]);
#pragma unroll
    for (int c = 0; c < 3; ++c) xg[k][c] = a.x[3 * vtx + c];
  }
  // F_{ia,b} = u + sum_k cp[3b+k] x[idx_k, ia], corners added in order
  T f[6], uo[6];
#pragma unroll
  for (int ia = 0; ia < 3; ++ia)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      T acc = a.tu[(2 * ia + b) * sE + t];
      uo[2 * ia + b] = acc;
#pragma unroll
      for (int k = 0; k < 3; ++k) acc = acc + tab[3 * b + k] * xg[k][ia];
      f[2 * ia + b] = acc;
    }
  const T w2 = tab[6];
  T z[6];
  tri::tri_body<T>(f, w2, tab[7], tab[8], tab[9], tab[10], a.limiting != 0,
                   z);
  T zu[6], r2 = T(0);
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const T un = f[q] - z[q];
    a.tu[q * sE + t] = un;
    zu[q] = w2 * (f[q] - T(2) * un);  // w2 (z - u')
    if constexpr (COLLECT != residuals::NONE) {
      const T du = un - uo[q];  // = D x - z
      r2 = r2 + du * du;
    }
  }
  tri_rows<T>(tab, zu, a.rows, R, sE, t);
  if constexpr (COLLECT == residuals::FULL) {
    T zz[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) zz[q] = w2 * z[q];
    tri_rows<T>(tab, zz, a.zrows, R, sE, t);
  }
  return w2 * r2;
}

// Hinge h: flat-state bend projection, dual update, its 4 x 3 RHS rows.
// Returns its piece of the squared primal residual (COLLECT), and under
// FULL writes its rows of w2 D^T z.
template <typename T, int COLLECT>
__device__ __forceinline__ T bend_step(const Args<T>& a, int h) {
  const size_t sE = static_cast<size_t>(a.Eh);
  const size_t sT = static_cast<size_t>(a.Et);
  const size_t R = 3 * sT + 4 * sE;
  const T* tab = a.htab + BEND_TAB * a.hgrp[h];
  T xg[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const size_t vtx = static_cast<size_t>(a.hidx[k * sE + h]);
#pragma unroll
    for (int c = 0; c < 3; ++c) xg[k][c] = a.x[3 * vtx + c];
  }
  // D rows (x0 - x2, x3 - x2, x1 - x2): corner 0, 3, 1 is each + term
  T f[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int plus = r == 0 ? 0 : (r == 1 ? 3 : 1);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      f[3 * r + j] = (a.hu[(3 * r + j) * sE + h] + xg[plus][j]) - xg[2][j];
  }
  const T inv_denom = tab[6], w2 = tab[7], k = tab[8], mix = tab[9];
  T zu[9], zz[9], du[9];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T lam =
        inv_denom * (tab[0] * f[j] + tab[1] * f[3 + j] + tab[2] * f[6 + j]);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const T fp = f[3 * r + j];
      const T z = (k * (fp - tab[3 + r] * lam) + w2 * fp) * mix;
      const T un = fp - z;
      if constexpr (COLLECT != residuals::NONE)
        du[3 * r + j] = un - a.hu[(3 * r + j) * sE + h];
      a.hu[(3 * r + j) * sE + h] = un;
      zu[3 * r + j] = w2 * (fp - T(2) * un);
      zz[3 * r + j] = w2 * z;
    }
  }
  bend_rows<T>(zu, a.rows + 3 * sT + h, R, sE);
  if constexpr (COLLECT == residuals::NONE) {
    return T(0);
  } else {
    if constexpr (COLLECT == residuals::FULL)
      bend_rows<T>(zz, a.zrows + 3 * sT + h, R, sE);
    T r2 = T(0);
#pragma unroll
    for (int q = 0; q < 9; ++q) r2 = r2 + du[q] * du[q];
    return w2 * r2;
  }
}

// The dual residual's seed (FULL), element e (triangle e < Et, else hinge
// e - Et): its rows of w2 D^T D x_pre, formed directly, as the general
// route forms z_prev = D x_pre (system.py:604-616), rather than by the
// Pallas kernel's identity (A_hat - M) x_pre / dt^2 (cloth_step.py:
// 597-606), which in f32 subtracts two nearly equal terms.
template <typename T>
__device__ __forceinline__ void seed_rows(const Args<T>& a, int e) {
  const size_t sT = static_cast<size_t>(a.Et);
  const size_t sH = static_cast<size_t>(a.Eh);
  const size_t R = 3 * sT + 4 * sH;
  if (e < a.Et) {
    const T* tab = a.ttab + TRI_TAB * a.tgrp[e];
    T xg[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const size_t vtx = static_cast<size_t>(a.tidx[k * sT + e]);
#pragma unroll
      for (int c = 0; c < 3; ++c) xg[k][c] = a.xpre[3 * vtx + c];
    }
    T zz[6];
#pragma unroll
    for (int ia = 0; ia < 3; ++ia)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        T acc = tab[3 * b] * xg[0][ia];
        acc = acc + tab[3 * b + 1] * xg[1][ia];
        acc = acc + tab[3 * b + 2] * xg[2][ia];
        zz[2 * ia + b] = tab[6] * acc;
      }
    tri_rows<T>(tab, zz, a.zrows, R, sT, e);
    return;
  }
  const int h = e - a.Et;
  const T* tab = a.htab + BEND_TAB * a.hgrp[h];
  T xg[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const size_t vtx = static_cast<size_t>(a.hidx[k * sH + h]);
#pragma unroll
    for (int c = 0; c < 3; ++c) xg[k][c] = a.xpre[3 * vtx + c];
  }
  T zz[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int plus = r == 0 ? 0 : (r == 1 ? 3 : 1);
#pragma unroll
    for (int j = 0; j < 3; ++j) zz[3 * r + j] = tab[7] * (xg[plus][j] - xg[2][j]);
  }
  bend_rows<T>(zz, a.zrows + 3 * sT + h, R, sH);
}

// The incidence sum of vertex i's rows (3,R) in slot order, no atomics.
template <typename T>
__device__ __forceinline__ void gather_rows(const Args<T>& a, const T* rows,
                                            int i, T out[3]) {
  const size_t si = static_cast<size_t>(i);
  const int total = 3 * a.Et + 4 * a.Eh;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = T(0);
  for (int j = 0; j < a.S; ++j) {
    const int slot = a.inc[si * a.S + j];
    if (slot >= total) break;  // the sentinels follow the real slots
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[c] = out[c] + rows[static_cast<size_t>(c) * total + slot];
  }
}

// Vertex i: RHS, anchor dual, then rhs = M xbar + dt^2 b. Returns its
// piece of the squared primal residual, aw2 ||x - ancz||^2 (COLLECT);
// under FULL, T z = the incidence sum of zrows + aw2 ancz replaces a.tz[i]
// and dual takes ||T z - T z_prev||^2.
template <typename T, int COLLECT>
__device__ __forceinline__ T vertex_step(const Args<T>& a, int i, T* dual) {
  const size_t si = static_cast<size_t>(i);
  T b[3], tz[3];
  gather_rows(a, static_cast<const T*>(a.rows), i, b);
  if constexpr (COLLECT == residuals::FULL)
    gather_rows(a, static_cast<const T*>(a.zrows), i, tz);
  const T aw2 = a.aw2[i];
  T r2 = T(0);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T anc = a.ancz[3 * si + c];
    const T dlt = a.x[3 * si + c] - anc;
    // gated: a vertex with no anchor weight keeps a zero dual
    const T aun = aw2 > T(0) ? a.au[3 * si + c] + dlt : T(0);
    a.au[3 * si + c] = aun;
    b[c] = b[c] + aw2 * (anc - aun);
    a.rhs[3 * si + c] = a.mxbar[3 * si + c] + a.sc[DT2] * b[c];
    if constexpr (COLLECT != residuals::NONE) r2 = r2 + dlt * dlt;
    if constexpr (COLLECT == residuals::FULL) tz[c] = tz[c] + aw2 * anc;
  }
  if constexpr (COLLECT == residuals::FULL) {
    T d2 = T(0);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T d = tz[c] - a.tz[3 * si + c];
      d2 = d2 + d * d;
      a.tz[3 * si + c] = tz[c];
    }
    *dual = d2;
  }
  return aw2 * r2;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    wind_kernel(const __grid_constant__ Args<T> a) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w < a.Ew) wind_step(a, w);
}

// Vertex i: v += dt g where m > 0, then its wind triangles' forces in
// incidence order; x_pre = x; x += dt v; M xbar = m x.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    kick_kernel(const __grid_constant__ Args<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t si = static_cast<size_t>(i);
  const T m = a.mass[i];
  T vc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    vc[c] = a.v[3 * si + c] + (m > T(0) ? a.sc[DTG0 + c] : T(0));
  for (int j = 0; j < a.Sw; ++j) {
    const int w = a.winc[si * a.Sw + j];
    if (w >= a.Ew) break;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      vc[c] = vc[c] + a.wf[static_cast<size_t>(c) * a.Ew + w];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const size_t q = 3 * si + c;
    a.v[q] = vc[c];
    const T xs = a.x[q];
    a.xpre[q] = xs;
    const T xn = xs + a.sc[DT] * vc[c];
    a.x[q] = xn;
    a.mxbar[q] = m * xn;
  }
}

static_assert(THREADS == residuals::THREADS, "one block size");

// Element e: triangle e (e < Et) or hinge e - Et.
template <typename T, int COLLECT>
__global__ void __launch_bounds__(THREADS)
    element_kernel(const __grid_constant__ Args<T> a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  T r2 = T(0);
  if (e < a.Et)
    r2 = tri_step<T, COLLECT>(a, e);
  else if (e < a.Et + a.Eh)
    r2 = bend_step<T, COLLECT>(a, e - a.Et);
  if constexpr (COLLECT != residuals::NONE)
    residuals::block_partial(
        r2, a.part + static_cast<size_t>(a.it) * (a.eb + a.vb) + blockIdx.x);
}

template <typename T, int COLLECT>
__global__ void __launch_bounds__(THREADS)
    vertex_kernel(const __grid_constant__ Args<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  T r2 = T(0), d2 = T(0);
  if (i < a.n) r2 = vertex_step<T, COLLECT>(a, i, &d2);
  if constexpr (COLLECT != residuals::NONE)
    residuals::block_partial(r2, a.part +
                                     static_cast<size_t>(a.it) *
                                         (a.eb + a.vb) +
                                     a.eb + blockIdx.x);
  if constexpr (COLLECT == residuals::FULL)
    residuals::block_partial(
        d2, a.dpart + static_cast<size_t>(a.it) * a.vb + blockIdx.x);
}

// The dual residual's seed (FULL): the rows of w2 D^T D x_pre, then per
// vertex T z_prev = their incidence sum + aw2 x_pre.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    seed_element_kernel(const __grid_constant__ Args<T> a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < a.Et + a.Eh) seed_rows(a, e);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    seed_vertex_kernel(const __grid_constant__ Args<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t si = static_cast<size_t>(i);
  T tz[3];
  gather_rows(a, static_cast<const T*>(a.zrows), i, tz);
  const T aw2 = a.aw2[i];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    a.tz[3 * si + c] = tz[c] + aw2 * a.xpre[3 * si + c];
}

template <typename T, int COLLECT>
void* kernel_pair(void** vertex) {
  *vertex = (void*)vertex_kernel<T, COLLECT>;
  return (void*)element_kernel<T, COLLECT>;
}

template <typename T>
int launch(T* x, T* v, T* tu, T* hu, T* au, const int* tidx, const int* tgrp,
           const T* ttab, const int* hidx, const int* hgrp, const T* htab,
           const int* widx, const T* mass, const T* invd, const T* aw2,
           const T* ancz, const T* dia_vals, const int* inc, const int* winc,
           T* xpre, T* mxbar, T* rows, T* wf, T* rhs, T* scratch, T* zrows,
           T* tz, T* part, T* dpart, T* res_p, T* res_d, const int* offsets,
           const double* scalars, const void* mg, int n, int Et, int Eh,
           int Ew, int D, int H, int S, int Sw, int limiting, int cg_iters,
           int admm_iters, int n_steps, int collect, void* stream) {
  if (n < 1 || Et < 1 || Eh < 0 || Ew < 0 || D < 1 ||
      D > dia::MAX_DIAGONALS || H < 0 || S < 1 || Sw < 1 || cg_iters < 0 ||
      admm_iters < 0 || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // what each residual mode writes
  if (collect < residuals::NONE || collect > residuals::FULL ||
      (collect != residuals::NONE && (part == nullptr || res_p == nullptr)) ||
      (collect == residuals::FULL &&
       (zrows == nullptr || tz == nullptr || dpart == nullptr ||
        res_d == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a{};
  a.x = x; a.v = v; a.tu = tu; a.hu = hu; a.au = au;
  a.tidx = tidx; a.tgrp = tgrp; a.ttab = ttab;
  a.hidx = hidx; a.hgrp = hgrp; a.htab = htab; a.widx = widx;
  a.mass = mass; a.aw2 = aw2; a.ancz = ancz; a.inc = inc; a.winc = winc;
  a.xpre = xpre; a.mxbar = mxbar; a.rows = rows; a.wf = wf; a.rhs = rhs;
  a.zrows = zrows; a.tz = tz; a.part = part; a.dpart = dpart;
  a.n = n; a.Et = Et; a.Eh = Eh; a.Ew = Ew; a.S = S; a.Sw = Sw;
  a.limiting = limiting;
  for (int q = 0; q < N_SCALARS; ++q) a.sc[q] = static_cast<T>(scalars[q]);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 vb = window::blocks_for(n), eb = window::blocks_for(Et + Eh);
  a.eb = static_cast<int>(eb.x);
  a.vb = static_cast<int>(vb.x);
  // each launch takes a copy of a: `it` is set before the ADMM
  // iteration's launches
  void* kargs[] = {&a};
  void* vertex = nullptr;
  void* element = collect == residuals::NONE
                      ? kernel_pair<T, residuals::NONE>(&vertex)
                  : collect == residuals::PRIMAL
                      ? kernel_pair<T, residuals::PRIMAL>(&vertex)
                      : kernel_pair<T, residuals::FULL>(&vertex);
  window::clear_errors();
  for (int step = 0; step < n_steps; ++step) {
    int err = 0;
    if (Ew > 0)
      err = static_cast<int>(cudaLaunchKernel(
          (void*)wind_kernel<T>, window::blocks_for(Ew), dim3(THREADS),
          kargs, 0, st));
    if (err == 0)
      err = static_cast<int>(cudaLaunchKernel(
          (void*)kick_kernel<T>, vb, dim3(THREADS), kargs, 0, st));
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
        err = mg != nullptr
                  ? window::mg_solve(rhs, x, dia_vals, offsets, D, n,
                                     cg_iters, mg, scratch, st)
                  : window::solve(rhs, x, invd, dia_vals, offsets, D,
                                  nullptr, nullptr, 0, H, n, cg_iters,
                                  scratch, st);
    }
    if (err != 0) return window::failed(err);
    window::end_kernel<T><<<vb, THREADS, 0, st>>>(x, v, xpre, a.sc[INV_DT],
                                                 n);
    err = window::launched();
    if (err == 0 && collect != residuals::NONE) {
      const size_t at = static_cast<size_t>(step) * admm_iters;
      const bool full = collect == residuals::FULL;
      residuals::finalize_kernel<T><<<1, THREADS, 0, st>>>(
          part, a.eb + a.vb, full ? dpart : nullptr, a.vb, admm_iters,
          a.sc[DT2], 0, res_p + at, full ? res_d + at : nullptr);
      err = window::launched();
    }
    if (err != 0) return window::failed(err);
  }
  return 0;
}

}  // namespace cloth
}  // namespace admm

#define ADMM_CLOTH_ENTRY(T, SUFFIX)                                           \
  int cloth_rollout_##SUFFIX(                                                 \
      T* x, T* v, T* tu, T* hu, T* au, const int* tidx, const int* tgrp,      \
      const T* ttab, const int* hidx, const int* hgrp, const T* htab,         \
      const int* widx, const T* mass, const T* invd, const T* aw2,            \
      const T* ancz, const T* dia_vals, const int* inc, const int* winc,      \
      T* xpre, T* mxbar, T* rows, T* wf, T* rhs, T* scratch, T* zrows,        \
      T* tz, T* part, T* dpart, T* res_p, T* res_d, const int* offsets,       \
      const double* scalars, const void* mg, int n, int Et, int Eh, int Ew,   \
      int D, int H, int S, int Sw, int limiting, int cg_iters,                \
      int admm_iters, int n_steps, int collect, void* stream) {               \
    return admm::cloth::launch<T>(                                            \
        x, v, tu, hu, au, tidx, tgrp, ttab, hidx, hgrp, htab, widx, mass,     \
        invd, aw2, ancz, dia_vals, inc, winc, xpre, mxbar, rows, wf, rhs,     \
        scratch, zrows, tz, part, dpart, res_p, res_d, offsets, scalars, mg,  \
        n, Et, Eh, Ew, D, H, S, Sw, limiting, cg_iters, admm_iters, n_steps,  \
        collect, stream);                                                     \
  }

extern "C" {

// The state (x, v, tu, hu, au) is advanced n_steps timesteps in place.
// dia_vals (D,n) holds A's diagonals at the D signed offsets, H at least
// their largest magnitude; xpre, mxbar, rhs (n,3), rows (3, 3 Et + 4 Eh)
// and wf (3,Ew) are scratch, and scratch holds the cluster solve's global
// scratch (cg_cluster_plan; nullptr when it is 0). offsets (D) and
// scalars (11: dt, dt^2, 1/dt, dt g xyz, the wind's -1000 0.33 dt, 1/3,
// the wind direction xyz, formed in double) are host arrays. mg: null for
// the Jacobi-PCG solve, else an mg::Host (mg_vcycle.cuh) whose V-cycle
// preconditions it (scratch then holds mg_dia_plan's count). collect: 0
// none, 1 the primal residuals, 2 also the dual ones, written to res_p and
// res_d (n_steps, admm_iters); zrows (3, 3 Et + 4 Eh), tz (n,3), part
// (admm_iters, eb + vb) and dpart (admm_iters, vb), with eb and vb the
// element and vertex blocks of 128 threads, are their scratch (null where
// the mode needs none). Every launch
// goes to `stream` (a CUDA graph capture takes them all; the solve's
// set-up, cg_dia_prepare_* or mg_dia_prepare_*, must run before). Returns
// the first nonzero cudaError_t of the launches, or 0.
ADMM_CLOTH_ENTRY(float, f32)
ADMM_CLOTH_ENTRY(double, f64)

}  // extern "C"
