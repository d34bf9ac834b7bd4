// The per-element and per-vertex phases of one ADMM iteration on a tet
// mesh, shared by the whole-timestep kernel (banded_step.cu) and the local
// phase of the sharded banded stepper (banded_local.cu).
//
// Both come from admm_elastic_tpu/ops/pallas/banded_step.py (the chunk
// phase and the solve phase's prologue), whose math the Pallas kernel
// banded_local.py repeats. The functions are generic over the caller's
// argument struct A, which names the fields they use: element planes idx
// (4,E), cp (12,E), w2, mu, lam, kp (E,); state x (n,3), u (9,E), warm
// (3,E), au, cu (n,3); rows (12,E); vertex planes aw2 (n,), ancz (n,3),
// inc (n,S); E, S, newton_iters, n_shapes, shape_kind, shape_prm and the
// scalars sc[] (COLL_W2 read here).
#pragma once

#include "arap.cuh"

namespace admm {
namespace banded {

constexpr int MAX_SHAPES = 16;
constexpr int SHAPE_PRM = 5;
enum ShapeKind { FLOOR = 0, SPHERE = 1, CYLINDER = 2 };
// scalars[]: dt, dt^2, 1/dt, dt g (3), collision weight^2
enum Scalar { DT = 0, DT2, INV_DT, DTG0, DTG1, DTG2, COLL_W2, N_SCALARS };

// Element e: local step, dual update and its 12 RHS rows.
template <typename T, int MODEL, typename A>
__device__ __forceinline__ void element_step(const A& a, int e) {
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
  T zu[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const T up = f[q] - z[q];
    a.u[q * sE + e] = up;
    zu[q] = w2e * (f[q] - T(2) * up);  // z - u' = F - 2u'
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

// Vertex i: its RHS b = the incidence sum of the element rows (slot
// order, no atomics), the anchor dual (zero where the anchor weight is 0)
// and its RHS, the collision shapes in declaration order, their dual and
// RHS. Updates a.au and a.cu in place and returns b.
template <typename T, typename A>
__device__ __forceinline__ void vertex_rhs(const A& a, int i, T b[3]) {
  const size_t si = static_cast<size_t>(i);
  const int total = 4 * a.E;
  const size_t sE = static_cast<size_t>(a.E);
#pragma unroll
  for (int c = 0; c < 3; ++c) b[c] = T(0);
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
}

}  // namespace banded
}  // namespace admm
