// Triangle strain-limited projection: the device functions shared by the
// fused triangle local step (tri_local.cu) and the whole-timestep cloth
// kernel (cloth_step.cu).
//
// A literal transcription of admm_elastic_tpu/ops/pallas/tri_local.py
// (_svd32, _tri_body): the closed-form 2x2 eigendecomposition of F^T F, the
// better-conditioned eigenvector candidate (n1 >= n2), the ok/ok0/ok1
// thresholds, the fallback axis least aligned with u0 (ties with <=), and
// the column-norm clamp with max(l, 1e-6); in the same evaluation order,
// so that a build without FMA contraction equals the plain PyTorch twin.
#pragma once

#include "common.cuh"

namespace admm {
namespace tri {

template <typename T>
__device__ __forceinline__ T norm3(T a, T b, T c) {
  return sqrt(a * a + b * b + c * c);
}

// f: the 6 planes of F (3x2, plane 2a+b = F_{a,b}). U[i] is the i-th left
// singular vector (3 components), V[i] the i-th right one (2 components).
template <typename T>
__device__ __forceinline__ void svd32(const T f[6], T eps, T U[2][3],
                                      T V[2][2]) {
  const T a00 = f[0] * f[0] + f[2] * f[2] + f[4] * f[4];
  const T a11 = f[1] * f[1] + f[3] * f[3] + f[5] * f[5];
  const T a01 = f[0] * f[1] + f[2] * f[3] + f[4] * f[5];
  // closed-form symmetric 2x2 eigendecomposition
  const T tr = a00 + a11;
  const T diff = a00 - a11;
  const T rad = sqrt(diff * diff + T(4) * a01 * a01);
  const T w0 = T(0.5) * (tr + rad);
  // eigenvector for w0: the better-conditioned of (w0 - a11, a01) and
  // (a01, w0 - a00); (1, 0) for an isotropic F^T F
  const T c1x = w0 - a11, c1y = a01;
  const T c2x = a01, c2y = w0 - a00;
  const T n1 = c1x * c1x + c1y * c1y;
  const T n2 = c2x * c2x + c2y * c2y;
  const bool use1 = n1 >= n2;
  const T vx = use1 ? c1x : c2x;
  const T vy = use1 ? c1y : c2y;
  const T nn = sqrt(vmax(n1, n2));
  const bool ok = nn > eps * vmax(tr, T(1));
  const T inv = T(1) / (ok ? nn : T(1));
  const T c = ok ? vx * inv : T(1);
  const T s = ok ? vy * inv : T(0);
  V[0][0] = c;
  V[0][1] = s;
  V[1][0] = -s;
  V[1][1] = c;
  const T s0 = sqrt(vmax(w0, T(0)));

  T b0[3], b1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b0[a] = f[2 * a] * V[0][0] + f[2 * a + 1] * V[0][1];
    b1[a] = f[2 * a] * V[1][0] + f[2 * a + 1] * V[1][1];
  }
  const T tol = eps * T(16) * (s0 + eps);
  const T n0 = norm3(b0[0], b0[1], b0[2]);
  const bool ok0 = n0 > tol;
  const T inv0 = T(1) / (ok0 ? n0 : T(1));
#pragma unroll
  for (int a = 0; a < 3; ++a)
    U[0][a] = ok0 ? b0[a] * inv0 : (a == 0 ? T(1) : T(0));

  const T d01 = U[0][0] * b1[0] + U[0][1] * b1[1] + U[0][2] * b1[2];
  T p1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) p1[a] = b1[a] - d01 * U[0][a];
  const T np1 = norm3(p1[0], p1[1], p1[2]);
  const bool ok1 = np1 > tol;
  const T inv1 = T(1) / (ok1 ? np1 : T(1));
  // fallback axis least aligned with u0
  const T au0 = fabs(U[0][0]), au1 = fabs(U[0][1]), au2 = fabs(U[0][2]);
  const bool use_x = (au0 <= au1) && (au0 <= au2);
  const bool use_y = !use_x && (au1 <= au2);
  const T ax[3] = {use_x ? T(1) : T(0), use_y ? T(1) : T(0),
                   (use_x || use_y) ? T(0) : T(1)};
  const T dax = ax[0] * U[0][0] + ax[1] * U[0][1] + ax[2] * U[0][2];
  T fb[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) fb[a] = ax[a] - dax * U[0][a];
  const T fbn = norm3(fb[0], fb[1], fb[2]);
  const T fbd = fbn > T(0) ? fbn : T(1);
#pragma unroll
  for (int a = 0; a < 3; ++a) U[1][a] = ok1 ? p1[a] * inv1 : fb[a] / fbd;
}

// F planes -> z planes: z = (k T + w2 F) denom with T = U V^T and denom =
// 1/(w2 + k) (formed by the caller), then, when limiting, each column of z
// scaled so its norm lies in [lmin, lmax] (TriangleForce.cpp:100-107).
template <typename T>
__device__ __forceinline__ void tri_body(const T f[6], T w2, T k, T denom,
                                         T lmin, T lmax, bool limiting,
                                         T z[6]) {
  T U[2][3], V[2][2];
  svd32<T>(f, Limits<T>::eps(), U, V);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const T t = U[0][a] * V[0][b] + U[1][a] * V[1][b];
      z[2 * a + b] = (k * t + w2 * f[2 * a + b]) * denom;
    }
  if (limiting) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const T l = norm3(z[b], z[2 + b], z[4 + b]);
      const T safe = vmax(l, T(1e-6));
      const T scale = l < lmin ? lmin / safe : (l > lmax ? lmax / safe : T(1));
#pragma unroll
      for (int a = 0; a < 3; ++a) z[2 * a + b] = z[2 * a + b] * scale;
    }
  }
}

}  // namespace tri
}  // namespace admm
