// Corotational (ARAP) tet element step: the closest proper rotation R to F
// and the proximal mix z = (k R + w2 F) / (w2 + k); and the signed
// projection of the whole-timestep kernels.
//
// Transcribed from admm_elastic_tpu/ops/pallas/tet_local.py
// (_polar_rotation, _arap_kernel). _polar_rotation is, operation for
// operation, nh_local._svd_columns without the singular values: 6 Jacobi
// sweeps on F^T F scaled by max(|a_ii|, 1) (jacobi_cs: sign(0) = 0 gives
// t = 0), the descending sorting network with strict < swaps, the
// det(V) < 0 column flip, Gram-Schmidt of F V with tolerance
// eps 16 (sqrt(max(w0 scale, 0)) + eps) (eps of T) and the least-aligned
// axis fallback with its <= ties. So it is hyper::svd_columns (whose
// singular values the compiler drops as dead code), then R = U V^T emitted
// row-major (r[3r+c] = R_{r,c}, the plane order of F).
#pragma once

#include "hyper.cuh"

namespace admm {
namespace arap {

template <typename T>
__device__ __forceinline__ void polar_rotation(const T f[9], T R[9]) {
  T U[3][3], V[3][3], s[3];
  hyper::svd_columns<T>(f, Limits<T>::eps(), U, V, s);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      R[3 * r + c] = U[0][r] * V[0][c] + U[1][r] * V[1][c] + U[2][r] * V[2][c];
}

// The whole-timestep kernels' ARAP projection, row-major: U diag(1, 1,
// +-1) V^T with the sign of the signed third singular value, written as
// the Pallas kernels write it, sigma = (1, 1, s3) inside the sum
// (banded_step.py:374-388, lattice_step.py:238-252). On an inverted F it
// keeps the reflection, where polar_rotation gives the proper rotation.
template <typename T>
__device__ __forceinline__ void signed_projection(T U[3][3], T V[3][3],
                                                  const T s[3], T P[9]) {
  const T s3 = s[2] < T(0) ? T(-1) : T(1);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      P[3 * r + c] = U[0][r] * T(1) * V[0][c] + U[1][r] * T(1) * V[1][c] +
                     U[2][r] * s3 * V[2][c];
}

// z = (k R + w2 F) * (1 / (w2 + k)) and u' = u + Dx - z, F = Dx + u.
template <typename T>
__device__ __forceinline__ void element(const T dx[9], const T uu[9], T w2,
                                        T k, T z[9], T un[9]) {
  T f[9], R[9];
#pragma unroll
  for (int p = 0; p < 9; ++p) f[p] = dx[p] + uu[p];
  polar_rotation<T>(f, R);
  const T denom = T(1) / (w2 + k);
#pragma unroll
  for (int p = 0; p < 9; ++p) {
    z[p] = (k * R[p] + w2 * f[p]) * denom;
    un[p] = uu[p] + dx[p] - z[p];
  }
}

}  // namespace arap
}  // namespace admm
