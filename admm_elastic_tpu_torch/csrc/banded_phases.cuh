// The per-element and per-vertex phases of one ADMM iteration on a tet
// mesh, shared by the whole-timestep kernel (banded_step.cu) and the local
// phase of the sharded banded stepper (banded_local.cu).
//
// Both come from admm_elastic_tpu/ops/pallas/banded_step.py (the chunk
// phase and the solve phase's prologue), whose math the Pallas kernel
// banded_local.py repeats. The functions are generic over the caller's
// argument struct A, which names the fields they use: element planes idx,
// pos (4,E), cp (12,E), w2, mu, lam, kp (E,); state x (n,3), u (9,E), warm
// (3,E), au, cu (n,3); the slot buffer rows (4E,4); vertex planes aw2
// (n,), off (n+1,), ancz (n,3); n, E, newton_iters, n_shapes, shape_kind,
// shape_prm and the scalars sc[] (COLL_W2 read here).
//
// The element rows reach the vertices through SLOTS: vertex i's incidence
// lists its (element, corner) pairs in ascending order of 4e+k
// (core/solver.assemble_transpose_incidence). The slot buffer holds them
// vertex by vertex, in that order, with no padding: 4E rows of 4 values
// (a corner's 3 rows and a pad: one 16-byte access, two in f64), vertex
// i's slots at rows off[i] .. off[i+1] - 1, and pos[k,e] = off[i] + j the
// row of corner k of element e, its vertex i and its place j in i's list
// (ops/kernels/banded_step.slot_planes). The element phase writes each
// corner's rows straight into its slot, which no other thread writes;
// the vertex phase then reads its own run of slots, independent loads of
// whole lines, and adds them in order: the sum the incidence walk gave,
// bit for bit, with no dependent chain of index loads and no atomics.
// pos is read after the element's arithmetic, so nothing of the scatter
// is live across it.
//
// Residual collection is a compile-time mode, COLLECT (residuals.cuh):
// NONE computes nothing more than the phases themselves; PRIMAL
// returns each element's and vertex's piece of the squared primal residual
// ||W (D x - z)||^2 (banded_step.py:390-398, 464-466, 509-511); FULL also
// forms the dual residual's rows (element: zrows (12,E), the rows of w2 D^T
// z) and its vertex sums T z (vertex: tz (n,3) holds the previous
// iteration's T z and takes this one's), as banded_step.py:405-441,
// 464-465, 509-510.
#pragma once

#include "arap.cuh"
#include "residuals.cuh"

namespace admm {
namespace banded {

constexpr int MAX_SHAPES = 16;
constexpr int SHAPE_PRM = 5;
enum ShapeKind { FLOOR = 0, SPHERE = 1, CYLINDER = 2 };
// scalars[]: dt, dt^2, 1/dt, dt g (3), collision weight^2
enum Scalar { DT = 0, DT2, INV_DT, DTG0, DTG1, DTG2, COLL_W2, N_SCALARS };

// A slot of the slot buffer: 3 values and a pad, 16-byte aligned.
__device__ __forceinline__ void store_slot(float* s, const float v[3]) {
  *reinterpret_cast<float4*>(s) = make_float4(v[0], v[1], v[2], 0.0f);
}

__device__ __forceinline__ void store_slot(double* s, const double v[3]) {
  reinterpret_cast<double2*>(s)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(s)[1] = make_double2(v[2], 0.0);
}

__device__ __forceinline__ void load_slot(const float* s, float v[3]) {
  const float4 q = *reinterpret_cast<const float4*>(s);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
}

__device__ __forceinline__ void load_slot(const double* s, double v[3]) {
  const double2 a = reinterpret_cast<const double2*>(s)[0];
  const double2 b = reinterpret_cast<const double2*>(s)[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
}

// Row 3k+j of element e = sum_b cp[4b+k] y[3j+b], from y already scaled
// by w2, the terms added in order of b, into corner k's slot (pos) of the
// slot buffer rows.
template <typename T, typename A>
__device__ __forceinline__ void tet_rows(const A& a, const T c[12],
                                         const T y[9], T* rows, int e) {
  const size_t sE = static_cast<size_t>(a.E);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    T v[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T acc = c[k] * y[3 * j];
      acc = acc + c[4 + k] * y[3 * j + 1];
      acc = acc + c[8 + k] * y[3 * j + 2];
      v[j] = acc;
    }
    store_slot(rows + 4 * static_cast<size_t>(a.pos[k * sE + e]), v);
  }
}

// Element e: local step, dual update and its 12 RHS rows. Returns its piece
// of the squared primal residual, w2 ||u' - u||^2 (0 without COLLECT).
template <typename T, int MODEL, int COLLECT = residuals::NONE, typename A>
__device__ __forceinline__ T element_step(const A& a, int e) {
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
  T f[9], uo[9];
#pragma unroll
  for (int ia = 0; ia < 3; ++ia)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      T acc = a.u[(3 * ia + b) * sE + e];
      uo[3 * ia + b] = acc;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = acc + c[4 * b + k] * xg[k][ia];
      f[3 * ia + b] = acc;
    }

  T U[3][3], V[3][3], s[3];
  hyper::svd_columns<T>(f, Limits<T>::eps(), U, V, s);
  const T w2e = a.w2[e];
  T z[9];
  if constexpr (MODEL == 2) {
    // arap (banded_step.py:374-388): sigma -> (1, 1, +-1),
    // z = (k P + w2 F) / (w2 + k), the warm start untouched
    const T kp = a.kp[e];
    const T mix = T(1) / (w2e + (w2e + kp > T(0) ? kp : T(1)));
    T P[9];
    arap::signed_projection<T>(U, V, s, P);
#pragma unroll
    for (int q = 0; q < 9; ++q) z[q] = (kp * P[q] + w2e * f[q]) * mix;
  } else {
    T w1 = a.warm[e], w2 = a.warm[sE + e], w3;
    hyper::warm_guard(w1, w2, a.warm[2 * sE + e], w3);
    hyper::newton_hyper<T, MODEL>(s, w1, w2, w3, a.mu[e], a.lam[e], a.kp[e],
                                  a.newton_iters);
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
  T zu[9], r2 = T(0);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const T up = f[q] - z[q];
    a.u[q * sE + e] = up;
    zu[q] = w2e * (f[q] - T(2) * up);  // z - u' = F - 2u'
    if constexpr (COLLECT != residuals::NONE) {
      const T du = up - uo[q];  // = D x - z
      r2 = r2 + du * du;
    }
  }
  tet_rows<T>(a, c, zu, a.rows, e);
  if constexpr (COLLECT == residuals::FULL) {
    T zz[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) zz[q] = w2e * z[q];
    tet_rows<T>(a, c, zz, a.zrows, e);
  }
  return w2e * r2;
}

// The dual residual's seed, element e: the rows of w2 D^T D x_pre, the
// image of z_prev = D x_pre at a step's first ADMM iteration
// (System.cpp:43). Formed directly, as the general route forms it
// (system.py:604-616), rather than by the Pallas kernel's identity
// (A_hat - M) x_pre / dt^2 (banded_step.py:890-902), which subtracts two
// nearly equal terms and in f32 loses most of the seed's digits.
template <typename T, typename A>
__device__ __forceinline__ void seed_rows(const A& a, int e) {
  const size_t sE = static_cast<size_t>(a.E);
  T xg[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const size_t vtx = static_cast<size_t>(a.idx[k * sE + e]);
#pragma unroll
    for (int c = 0; c < 3; ++c) xg[k][c] = a.xpre[3 * vtx + c];
  }
  T c[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) c[q] = a.cp[q * sE + e];
  const T w2e = a.w2[e];
  T zz[9];
#pragma unroll
  for (int ia = 0; ia < 3; ++ia)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      T acc = c[4 * b] * xg[0][ia];
#pragma unroll
      for (int k = 1; k < 4; ++k) acc = acc + c[4 * b + k] * xg[k][ia];
      zz[3 * ia + b] = w2e * acc;
    }
  tet_rows<T>(a, c, zz, a.zrows, e);
}

// Collision shapes in declaration order (banded_step.py:478-503).
template <typename T, typename A>
__device__ __forceinline__ void project(const A& a, T z[3]) {
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

// The incidence sum of vertex i's element rows (the slot buffer rows
// (4E,4)): its slots added in order, no atomics. The loads of SLOT_BATCH
// slots are issued before their adds.
constexpr int SLOT_BATCH = 8;

template <typename T, typename A>
__device__ __forceinline__ void gather_rows(const A& a, const T* rows, int i,
                                            T out[3]) {
  const int first = a.off[i], cnt = a.off[i + 1] - first;
  const T* col = rows + 4 * static_cast<size_t>(first);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = T(0);
  for (int j0 = 0; j0 < cnt; j0 += SLOT_BATCH) {
    T v[SLOT_BATCH][3];
#pragma unroll
    for (int q = 0; q < SLOT_BATCH; ++q) {
      if (j0 + q < cnt) load_slot(col + 4 * (j0 + q), v[q]);
    }
#pragma unroll
    for (int q = 0; q < SLOT_BATCH; ++q) {
      if (j0 + q < cnt) {
#pragma unroll
        for (int c = 0; c < 3; ++c) out[c] = out[c] + v[q][c];
      }
    }
  }
}

// Vertex i: its RHS b = the incidence sum of the element rows (slot
// order, no atomics), the anchor dual (zero where the anchor weight is 0)
// and its RHS, the collision shapes in declaration order, their dual and
// RHS. Updates a.au and a.cu in place and returns b. Returns the vertex's
// piece of the squared primal residual, aw2 ||x - ancz||^2 + cw2 ||x -
// zc||^2 (0 without COLLECT); under FULL, T z = the incidence sum of zrows
// + aw2 ancz + cw2 zc replaces a.tz[i], and dual takes ||T z - T z_prev||^2.
template <typename T, int COLLECT = residuals::NONE, typename A>
__device__ __forceinline__ T vertex_rhs(const A& a, int i, T b[3],
                                        T* dual = nullptr) {
  const size_t si = static_cast<size_t>(i);
  gather_rows(a, static_cast<const T*>(a.rows), i, b);
  T tz[3];
  if constexpr (COLLECT == residuals::FULL)
    gather_rows(a, static_cast<const T*>(a.zrows), i, tz);
  const T aw2 = a.aw2[i];
  T xi[3], r2 = T(0);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xi[c] = a.x[3 * si + c];
    const T anc = a.ancz[3 * si + c];
    const T dlt = xi[c] - anc;
    // gated: a vertex with no anchor weight keeps a zero dual
    const T aun = aw2 > T(0) ? a.au[3 * si + c] + dlt : T(0);
    a.au[3 * si + c] = aun;
    b[c] = b[c] + aw2 * (anc - aun);
    if constexpr (COLLECT != residuals::NONE) r2 = r2 + dlt * dlt;
    if constexpr (COLLECT == residuals::FULL) tz[c] = tz[c] + aw2 * anc;
  }
  r2 = aw2 * r2;
  if (a.n_shapes > 0) {
    T z[3], rc = T(0);
#pragma unroll
    for (int c = 0; c < 3; ++c) z[c] = xi[c] + a.cu[3 * si + c];
    project(a, z);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T dlt = xi[c] - z[c];
      const T un = a.cu[3 * si + c] + dlt;
      a.cu[3 * si + c] = un;
      b[c] = b[c] + a.sc[COLL_W2] * (z[c] - un);
      if constexpr (COLLECT != residuals::NONE) rc = rc + dlt * dlt;
      if constexpr (COLLECT == residuals::FULL)
        tz[c] = tz[c] + a.sc[COLL_W2] * z[c];
    }
    r2 = r2 + a.sc[COLL_W2] * rc;
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
  return r2;
}

// The dual residual's seed at vertex i: T z_prev = the incidence sum of the
// seed rows + aw2 x_pre (+ cw2 x_pre with collision shapes), into a.tz.
template <typename T, typename A>
__device__ __forceinline__ void seed_vertex(const A& a, int i) {
  const size_t si = static_cast<size_t>(i);
  T tz[3];
  gather_rows(a, static_cast<const T*>(a.zrows), i, tz);
  const T aw2 = a.aw2[i];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T xp = a.xpre[3 * si + c];
    T t = tz[c] + aw2 * xp;
    if (a.n_shapes > 0) t = t + a.sc[COLL_W2] * xp;
    a.tz[3 * si + c] = t;
  }
}

}  // namespace banded
}  // namespace admm
