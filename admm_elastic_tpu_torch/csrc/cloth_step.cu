// Whole cloth ADMM timesteps in one persistent cooperative kernel, for
// Hopper.
//
// Replaces: admm_elastic_tpu/ops/pallas/cloth_step.py, _cloth_call
// (kernel _make_cloth_kernel), in Jacobi-PCG mode without the in-kernel
// multigrid and residuals: gravity and Wejchert-Haumann wind kicks, every
// ADMM iteration's triangle-strain and bend local steps, dual updates, the
// anchor dual and right-hand side, and a whole fixed-budget Jacobi-PCG
// solve with the symmetric-dia matvec, for n_steps timesteps per launch.
//
// Layout, with no padding and no lane planes: vertex arrays (n,3)
// row-major; element planes (P,E), elements sorted by stencil group, each
// with its group id; the per-group constants in small tables (formed in
// double on the host, as the Pallas kernel bakes them); the vertex ->
// RHS-row incidence inc (n,S) in (group, corner) order with a sentinel
// >= R after the real slots, and the vertex -> wind-triangle incidence
// winc (n,Sw) with sentinel >= Ew (ops/kernels/cloth_step.py).
//
// One timestep (barriers are grid-wide, cooperative_groups grid.sync()):
//   with wind: barrier (steps after the first); per wind triangle: the drag
//     from x and the gravity-kicked v of its corners                barrier
//   prologue, per vertex: v += dt g where m > 0, then its wind triangles'
//     forces in incidence order; x_pre = x; x += dt v; M xbar = m x barrier
//   admm_iters times:
//     element phase, one thread per triangle or hinge: F, the strain-
//       limited projection (tri.cuh) or the alpha-weighted flat projection
//       (cloth_step.py:340-420), u' = F - z, RHS rows w2 D^T (F - 2u')
//                                                                   barrier
//     vertex phase, one thread per vertex: b = its incidence rows summed
//       in slot order (fixed order, no atomics); anchor dual (zero where
//       the anchor weight is 0) and RHS; r = M xbar + dt^2 b - A x;
//       p = D^-1 r; per-block partials of r.p                      barrier
//     cg_iters times the three stages of coop_pcg.cuh with the
//       symmetric-dia row (dia.cuh dia_row_sym)                  3 barriers
//   epilogue, per vertex: v = (x - x_pre) (1/dt)
// The arithmetic follows the Pallas kernel's evaluation order; the plain
// PyTorch twin (ops/kernels/cloth_step.py) follows the same order.
//
// What bounds it on this card: at the cloth100k sheet (n = 51,076,
// 101,250 triangles, 151,425 hinges, 7 diagonals of which 4 are stored)
// the working set is ~35 MB in f32, L2-sized (50 MB), so device memory is
// not the limit; the element phase is a few hundred flops per element, and the
// rest is the chain of 2 + 3k grid barriers per ADMM iteration (k =
// cg_iters), each costing a few microseconds, with a few microseconds of
// work between them.
//
// Design: the skeleton of banded_step.cu. One launch per rollout window,
// grid = SMs x the occupancy the register count allows, so every block is
// resident and grid.sync() is legal; a refused launch returns its
// cudaError_t. Every phase is a grid-stride loop, and a vertex keeps the
// same thread in every vertex phase. No thread returns early. Buffers
// written during the launch are never read through the non-coherent
// (const __restrict__) path.

#include "coop_pcg.cuh"
#include "tri.cuh"

namespace admm {
namespace cloth {

namespace cgr = cooperative_groups;

constexpr int THREADS = 128;
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
  const T* __restrict__ invd;
  const T* __restrict__ aw2;
  const T* __restrict__ ancz;   // (n,3)
  const T* __restrict__ dia;    // (D,n), offsets >= 0
  const int* __restrict__ inc;  // (n,S)
  const int* __restrict__ winc; // (n,Sw)
  // scratch
  T* xpre;
  T* mxbar;
  T* rows;  // (3,R), R = 3 Et + 4 Eh
  T* wf;    // (3,Ew)
  T* r;
  T* p;
  T* ap;
  T* part;  // 2 * gridDim.x
  int n, Et, Eh, Ew, D, S, Sw, limiting, cg_iters, admm_iters, n_steps;
  T sc[N_SCALARS];
  dia::Offsets offs;
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

// Triangle t: strain-limited local step, dual update, its 3 x 3 RHS rows.
template <typename T>
__device__ __forceinline__ void tri_step(const Args<T>& a, int t) {
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
  T f[6];
#pragma unroll
  for (int ia = 0; ia < 3; ++ia)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      T acc = a.tu[(2 * ia + b) * sE + t];
#pragma unroll
      for (int k = 0; k < 3; ++k) acc = acc + tab[3 * b + k] * xg[k][ia];
      f[2 * ia + b] = acc;
    }
  const T w2 = tab[6];
  T z[6];
  tri::tri_body<T>(f, w2, tab[7], tab[8], tab[9], tab[10], a.limiting != 0,
                   z);
  T zu[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const T un = f[q] - z[q];
    a.tu[q * sE + t] = un;
    zu[q] = w2 * (f[q] - T(2) * un);  // w2 (z - u')
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a.rows[j * R + k * sE + t] =
          tab[k] * zu[2 * j] + tab[3 + k] * zu[2 * j + 1];
}

// Hinge h: flat-state bend projection, dual update, its 4 x 3 RHS rows.
template <typename T>
__device__ __forceinline__ void bend_step(const Args<T>& a, int h) {
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
  T zu[9];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T lam =
        inv_denom * (tab[0] * f[j] + tab[1] * f[3 + j] + tab[2] * f[6 + j]);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const T fp = f[3 * r + j];
      const T z = (k * (fp - tab[3 + r] * lam) + w2 * fp) * mix;
      const T un = fp - z;
      a.hu[(3 * r + j) * sE + h] = un;
      zu[3 * r + j] = w2 * (fp - T(2) * un);
    }
  }
  // D^T columns: corner 0 += row 0, corner 1 += row 2, corner 2 -= all
  // three rows, corner 3 += row 1
  T* out = a.rows + 3 * sT + h;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out[j * R] = zu[j];
    out[j * R + sE] = zu[6 + j];
    out[j * R + 2 * sE] = -((zu[j] + zu[3 + j]) + zu[6 + j]);
    out[j * R + 3 * sE] = zu[3 + j];
  }
}

// Vertex i: RHS, anchor dual, r = M xbar + dt^2 b - A x and p = D^-1 r.
// Returns this vertex's share of r.p.
template <typename T>
__device__ __forceinline__ T vertex_step(const Args<T>& a, int i) {
  const size_t si = static_cast<size_t>(i);
  const int total = 3 * a.Et + 4 * a.Eh;
  T b[3] = {T(0), T(0), T(0)};
  for (int j = 0; j < a.S; ++j) {
    const int slot = a.inc[si * a.S + j];
    if (slot >= total) break;  // the sentinels follow the real slots
#pragma unroll
    for (int c = 0; c < 3; ++c)
      b[c] = b[c] + a.rows[static_cast<size_t>(c) * total + slot];
  }
  const T aw2 = a.aw2[i];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T anc = a.ancz[3 * si + c];
    const T dlt = a.x[3 * si + c] - anc;
    // gated: a vertex with no anchor weight keeps a zero dual
    const T aun = aw2 > T(0) ? a.au[3 * si + c] + dlt : T(0);
    a.au[3 * si + c] = aun;
    b[c] = b[c] + aw2 * (anc - aun);
  }
  T ax[3];
  dia::dia_row_sym(a.dia, a.offs, a.D, a.n, i, static_cast<const T*>(a.x),
                   ax);
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

template <typename T>
__global__ void __launch_bounds__(THREADS) rollout_kernel(const Args<T> a) {
  cgr::grid_group grid = cgr::this_grid();
  __shared__ T sh[THREADS];
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gstride = gridDim.x * blockDim.x;
  const coop::PcgVecs<T> pcg_vecs{a.x, a.r, a.p, a.ap, a.invd, a.part, a.n};
  const auto row = [&a](int i, const T* y, T out[3]) {
    dia::dia_row_sym(a.dia, a.offs, a.D, a.n, i, y, out);
  };
  const int n_elem = a.Et + a.Eh;

  for (int step = 0; step < a.n_steps; ++step) {
    if (a.Ew > 0) {
      // wind reads other vertices' x and v: the previous epilogue first
      if (step > 0) grid.sync();
      for (int w = gtid; w < a.Ew; w += gstride) wind_step(a, w);
      grid.sync();
    }
    for (int i = gtid; i < a.n; i += gstride) {
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
    grid.sync();

    for (int it = 0; it < a.admm_iters; ++it) {
      for (int e = gtid; e < n_elem; e += gstride) {
        if (e < a.Et)
          tri_step(a, e);
        else
          bend_step(a, e - a.Et);
      }
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

// Blocks of the cooperative grid on the current device, or -cudaError_t.
template <typename T>
int grid_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rollout_kernel<T>, THREADS, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return sms * per_sm;
}

template <typename T>
int launch(T* x, T* v, T* tu, T* hu, T* au, const int* tidx, const int* tgrp,
           const T* ttab, const int* hidx, const int* hgrp, const T* htab,
           const int* widx, const T* mass, const T* invd, const T* aw2,
           const T* ancz, const T* dia_vals, const int* inc, const int* winc,
           T* xpre, T* mxbar, T* rows, T* wf, T* r, T* p, T* ap, T* part,
           const int* offsets, const double* scalars, int n, int Et, int Eh,
           int Ew, int D, int S, int Sw, int limiting, int cg_iters,
           int admm_iters, int n_steps, int part_len, void* stream) {
  if (n < 1 || Et < 1 || Eh < 0 || Ew < 0 || D < 1 ||
      D > dia::MAX_DIAGONALS || S < 1 || Sw < 1 || cg_iters < 0 ||
      admm_iters < 0 || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = grid_blocks<T>();
  if (blocks < 0) return -blocks;
  if (part_len < 2 * blocks) return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a{};
  a.x = x; a.v = v; a.tu = tu; a.hu = hu; a.au = au;
  a.tidx = tidx; a.tgrp = tgrp; a.ttab = ttab;
  a.hidx = hidx; a.hgrp = hgrp; a.htab = htab; a.widx = widx;
  a.mass = mass; a.invd = invd; a.aw2 = aw2; a.ancz = ancz;
  a.dia = dia_vals; a.inc = inc; a.winc = winc;
  a.xpre = xpre; a.mxbar = mxbar; a.rows = rows; a.wf = wf;
  a.r = r; a.p = p; a.ap = ap; a.part = part;
  a.n = n; a.Et = Et; a.Eh = Eh; a.Ew = Ew; a.D = D; a.S = S; a.Sw = Sw;
  a.limiting = limiting; a.cg_iters = cg_iters; a.admm_iters = admm_iters;
  a.n_steps = n_steps;
  for (int q = 0; q < N_SCALARS; ++q) a.sc[q] = static_cast<T>(scalars[q]);
  for (int d = 0; d < D; ++d) a.offs.v[d] = offsets[d];
  void* kargs[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)rollout_kernel<T>, dim3(blocks), dim3(THREADS), kargs, 0,
      static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace cloth
}  // namespace admm

#define ADMM_CLOTH_ENTRY(T, SUFFIX)                                           \
  int cloth_rollout_##SUFFIX(                                                 \
      T* x, T* v, T* tu, T* hu, T* au, const int* tidx, const int* tgrp,      \
      const T* ttab, const int* hidx, const int* hgrp, const T* htab,         \
      const int* widx, const T* mass, const T* invd, const T* aw2,            \
      const T* ancz, const T* dia_vals, const int* inc, const int* winc,      \
      T* xpre, T* mxbar, T* rows, T* wf, T* r, T* p, T* ap, T* part,          \
      const int* offsets, const double* scalars, int n, int Et, int Eh,       \
      int Ew, int D, int S, int Sw, int limiting, int cg_iters,               \
      int admm_iters, int n_steps, int part_len, void* stream) {              \
    return admm::cloth::launch<T>(                                            \
        x, v, tu, hu, au, tidx, tgrp, ttab, hidx, hgrp, htab, widx, mass,     \
        invd, aw2, ancz, dia_vals, inc, winc, xpre, mxbar, rows, wf, r, p,    \
        ap, part, offsets, scalars, n, Et, Eh, Ew, D, S, Sw, limiting,        \
        cg_iters, admm_iters, n_steps, part_len, stream);                     \
  }                                                                           \
  int cloth_rollout_grid_##SUFFIX() { return admm::cloth::grid_blocks<T>(); }

extern "C" {

// The state (x, v, tu, hu, au) is advanced n_steps timesteps in place.
// offsets (D) and scalars (11: dt, dt^2, 1/dt, dt g xyz, the wind's
// -1000 0.33 dt, 1/3, the wind direction xyz, formed in double) are host
// arrays. part holds part_len >= 2 x cloth_rollout_grid_*() values.
// Returns the cudaError_t of the launch, or 0.
ADMM_CLOTH_ENTRY(float, f32)
ADMM_CLOTH_ENTRY(double, f64)

}  // extern "C"
