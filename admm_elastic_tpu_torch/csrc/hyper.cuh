// Hyperelastic tet element step (NeoHookean / StVK): the device functions
// shared by the fused local-step kernel (nh_local.cu) and the whole-
// timestep kernel (banded_step.cu).
//
// Transcribed from admm_elastic_tpu/ops/pallas/nh_local.py (_svd_columns,
// _newton_hyper, with tet_local._jacobi_cs) in the same evaluation order,
// so that with --fmad=false and no fast math a kernel agrees with the
// plain PyTorch twins in ops/kernels/nh_local.py to round-off of log/sqrt.
#pragma once

#include "common.cuh"

namespace admm {
namespace hyper {

constexpr double SIGMA_FLOOR = 1e-8;
constexpr int SWEEPS = 6;

template <typename T>
__device__ __forceinline__ void jacobi_cs(T app, T aqq, T apq, T eps, T& c,
                                          T& s) {
  const bool small = fabs(apq) < eps;
  T tau = (aqq - app) / (T(2) * (small ? T(1) : apq));
  T t = sgn(tau) / (fabs(tau) + sqrt(T(1) + tau * tau));
  t = small ? T(0) : t;
  c = T(1) / sqrt(T(1) + t * t);
  s = t * c;
}

// Oriented SVD of F (row-major f[3r+c]). U[i][r], V[i][r] are column i.
template <typename T>
__device__ __forceinline__ void svd_columns(const T f[9], T eps, T U[3][3],
                                            T V[3][3], T s[3]) {
  T a00 = f[0] * f[0] + f[3] * f[3] + f[6] * f[6];
  T a11 = f[1] * f[1] + f[4] * f[4] + f[7] * f[7];
  T a22 = f[2] * f[2] + f[5] * f[5] + f[8] * f[8];
  T a01 = f[0] * f[1] + f[3] * f[4] + f[6] * f[7];
  T a02 = f[0] * f[2] + f[3] * f[5] + f[6] * f[8];
  T a12 = f[1] * f[2] + f[4] * f[5] + f[7] * f[8];
  const T scale =
      vmax(vmax(vmax(fabs(a00), fabs(a11)), fabs(a22)), T(1));
  a00 = a00 / scale; a11 = a11 / scale; a22 = a22 / scale;
  a01 = a01 / scale; a02 = a02 / scale; a12 = a12 / scale;

  T v[3][3] = {{T(1), T(0), T(0)}, {T(0), T(1), T(0)}, {T(0), T(0), T(1)}};
  auto rot_cols = [&](int p, int q, T c, T sn) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const T vp = v[r][p], vq = v[r][q];
      v[r][p] = c * vp - sn * vq;
      v[r][q] = sn * vp + c * vq;
    }
  };

#pragma unroll
  for (int sweep = 0; sweep < SWEEPS; ++sweep) {
    T c, sn, n00, n11, n22, n01, n02, n12;
    jacobi_cs(a00, a11, a01, eps, c, sn);
    n00 = c * c * a00 - T(2) * sn * c * a01 + sn * sn * a11;
    n11 = sn * sn * a00 + T(2) * sn * c * a01 + c * c * a11;
    n02 = c * a02 - sn * a12;
    n12 = sn * a02 + c * a12;
    a00 = n00; a11 = n11; a01 = T(0); a02 = n02; a12 = n12;
    rot_cols(0, 1, c, sn);

    jacobi_cs(a00, a22, a02, eps, c, sn);
    n00 = c * c * a00 - T(2) * sn * c * a02 + sn * sn * a22;
    n22 = sn * sn * a00 + T(2) * sn * c * a02 + c * c * a22;
    n01 = c * a01 - sn * a12;
    n12 = sn * a01 + c * a12;
    a00 = n00; a22 = n22; a02 = T(0); a01 = n01; a12 = n12;
    rot_cols(0, 2, c, sn);

    jacobi_cs(a11, a22, a12, eps, c, sn);
    n11 = c * c * a11 - T(2) * sn * c * a12 + sn * sn * a22;
    n22 = sn * sn * a11 + T(2) * sn * c * a12 + c * c * a22;
    n01 = c * a01 - sn * a02;
    n02 = sn * a01 + c * a02;
    a11 = n11; a22 = n22; a12 = T(0); a01 = n01; a02 = n02;
    rot_cols(1, 2, c, sn);
  }

  T w[3] = {a00, a11, a22};
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int r = 0; r < 3; ++r) V[c][r] = v[r][c];

  // sorting network, strict < (a tie keeps the order)
  auto cswap = [&](int i, int j) {
    const bool swap = w[i] < w[j];
    const T wi = w[i], wj = w[j];
    w[i] = swap ? wj : wi;
    w[j] = swap ? wi : wj;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const T ci = V[i][r], cj = V[j][r];
      V[i][r] = swap ? cj : ci;
      V[j][r] = swap ? ci : cj;
    }
  };
  cswap(0, 1);
  cswap(1, 2);
  cswap(0, 1);

  const T det = V[0][0] * (V[1][1] * V[2][2] - V[1][2] * V[2][1]) -
                V[1][0] * (V[0][1] * V[2][2] - V[0][2] * V[2][1]) +
                V[2][0] * (V[0][1] * V[1][2] - V[0][2] * V[1][1]);
  const T sflip = det < T(0) ? T(-1) : T(1);
#pragma unroll
  for (int r = 0; r < 3; ++r) V[2][r] = V[2][r] * sflip;

  T b[3][3];
#pragma unroll
  for (int ci = 0; ci < 3; ++ci) {
    b[ci][0] = f[0] * V[ci][0] + f[1] * V[ci][1] + f[2] * V[ci][2];
    b[ci][1] = f[3] * V[ci][0] + f[4] * V[ci][1] + f[5] * V[ci][2];
    b[ci][2] = f[6] * V[ci][0] + f[7] * V[ci][1] + f[8] * V[ci][2];
  }

  const T n0 = sqrt(b[0][0] * b[0][0] + b[0][1] * b[0][1] + b[0][2] * b[0][2]);
  const T tol = eps * T(16) * (sqrt(vmax(w[0] * scale, T(0))) + eps);
  const bool ok0 = n0 > tol;
  const T inv0 = T(1) / (ok0 ? n0 : T(1));
  T u0[3];
#pragma unroll
  for (int kk = 0; kk < 3; ++kk)
    u0[kk] = ok0 ? b[0][kk] * inv0 : (kk == 0 ? T(1) : T(0));

  const T d01 = u0[0] * b[1][0] + u0[1] * b[1][1] + u0[2] * b[1][2];
  T p1[3];
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) p1[kk] = b[1][kk] - d01 * u0[kk];
  const T n1 = sqrt(p1[0] * p1[0] + p1[1] * p1[1] + p1[2] * p1[2]);
  const bool ok1 = n1 > tol;
  const T inv1 = T(1) / (ok1 ? n1 : T(1));
  const T au0 = fabs(u0[0]), au1 = fabs(u0[1]), au2 = fabs(u0[2]);
  const bool use_x = (au0 <= au1) && (au0 <= au2);
  const bool use_y = (!use_x) && (au1 <= au2);
  const T ax[3] = {use_x ? T(1) : T(0), use_y ? T(1) : T(0),
                   (use_x || use_y) ? T(0) : T(1)};
  const T dax = ax[0] * u0[0] + ax[1] * u0[1] + ax[2] * u0[2];
  T fb[3];
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) fb[kk] = ax[kk] - dax * u0[kk];
  const T fbn = sqrt(fb[0] * fb[0] + fb[1] * fb[1] + fb[2] * fb[2]);
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) fb[kk] = fb[kk] / (fbn > T(0) ? fbn : T(1));
  T u1[3];
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) u1[kk] = ok1 ? p1[kk] * inv1 : fb[kk];
  const T u2[3] = {u0[1] * u1[2] - u0[2] * u1[1],
                   u0[2] * u1[0] - u0[0] * u1[2],
                   u0[0] * u1[1] - u0[1] * u1[0]};
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    U[0][kk] = u0[kk];
    U[1][kk] = u1[kk];
    U[2][kk] = u2[kk];
  }
  s[0] = u0[0] * b[0][0] + u0[1] * b[0][1] + u0[2] * b[0][2];
  s[1] = u1[0] * b[1][0] + u1[1] * b[1][1] + u1[2] * b[1][2];
  s[2] = u2[0] * b[2][0] + u2[1] * b[2][1] + u2[2] * b[2][2];
}

// Proximal objective; 3.4e38 where any sigma (or det) is non-positive.
template <typename T, int MODEL>
__device__ __forceinline__ T value(T s1, T s2, T s3, T mu, T lam, T k, T c1,
                                   T c2, T c3) {
  const T d1 = s1 - c1, d2 = s2 - c2, d3 = s3 - c3;
  const T prox = T(0.5) * k * (d1 * d1 + d2 * d2 + d3 * d3);
  bool valid = (s1 > T(0)) && (s2 > T(0)) && (s3 > T(0));
  T psi;
  if (MODEL == 0) {  // NeoHookean
    const T det = s1 * s2 * s3;
    const bool pos = det > T(0);
    const T logdet = log(pos ? det : T(1));
    const T I1 = s1 * s1 + s2 * s2 + s3 * s3;
    psi = T(0.5) * mu * (I1 - T(2) * logdet - T(3)) +
          T(0.5) * lam * logdet * logdet;
    valid = pos && valid;
  } else {  // StVK
    const T e1 = T(0.5) * (s1 * s1 - T(1));
    const T e2 = T(0.5) * (s2 * s2 - T(1));
    const T e3 = T(0.5) * (s3 * s3 - T(1));
    const T tr = e1 + e2 + e3;
    psi = mu * (e1 * e1 + e2 * e2 + e3 * e3) + T(0.5) * lam * tr * tr;
  }
  const T val = psi + prox;
  return valid ? val : T(3.4e38);
}

template <typename T, int MODEL>
__device__ __forceinline__ void try_step(T s1, T s2, T s3, T mu, T lam, T k,
                                         T c1, T c2, T c3, T& f_best, T& b1,
                                         T& b2, T& b3) {
  const T floor_ = T(SIGMA_FLOOR);
  const T t1 = vmax(s1, floor_), t2 = vmax(s2, floor_), t3 = vmax(s3, floor_);
  const T fv = value<T, MODEL>(t1, t2, t3, mu, lam, k, c1, c2, c3);
  const bool better = fv < f_best;  // strict: the first best candidate wins
  f_best = better ? fv : f_best;
  b1 = better ? t1 : b1;
  b2 = better ? t2 : b2;
  b3 = better ? t3 : b3;
}

template <typename T, int MODEL>
__device__ __forceinline__ void newton_hyper(const T s0[3], T& x1, T& x2,
                                             T& x3, T mu, T lam, T k,
                                             int iters) {
  const T c1 = s0[0], c2 = s0[1], c3 = s0[2];
  const T floor_ = T(SIGMA_FLOOR);
  x1 = vmax(x1, floor_);
  x2 = vmax(x2, floor_);
  x3 = vmax(x3, floor_);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    T g1, g2, g3, h11, h22, h33, h12, h13, h23;
    if (MODEL == 0) {
      const T inv1 = T(1) / x1, inv2 = T(1) / x2, inv3 = T(1) / x3;
      const T logdet = log(x1 * x2 * x3);
      g1 = mu * (x1 - inv1) + lam * logdet * inv1 + k * (x1 - c1);
      g2 = mu * (x2 - inv2) + lam * logdet * inv2 + k * (x2 - c2);
      g3 = mu * (x3 - inv3) + lam * logdet * inv3 + k * (x3 - c3);
      h11 = mu * (T(1) + inv1 * inv1) + (lam - lam * logdet) * inv1 * inv1 + k;
      h22 = mu * (T(1) + inv2 * inv2) + (lam - lam * logdet) * inv2 * inv2 + k;
      h33 = mu * (T(1) + inv3 * inv3) + (lam - lam * logdet) * inv3 * inv3 + k;
      h12 = lam * inv1 * inv2;
      h13 = lam * inv1 * inv3;
      h23 = lam * inv2 * inv3;
    } else {
      const T ss = x1 * x1 + x2 * x2 + x3 * x3;
      g1 = mu * x1 * (x1 * x1 - T(1)) + T(0.5) * lam * (ss - T(3)) * x1 + k * (x1 - c1);
      g2 = mu * x2 * (x2 * x2 - T(1)) + T(0.5) * lam * (ss - T(3)) * x2 + k * (x2 - c2);
      g3 = mu * x3 * (x3 * x3 - T(1)) + T(0.5) * lam * (ss - T(3)) * x3 + k * (x3 - c3);
      const T base = T(0.5) * lam * (ss - T(3)) + k;
      h11 = mu * (T(3) * x1 * x1 - T(1)) + base + lam * x1 * x1;
      h22 = mu * (T(3) * x2 * x2 - T(1)) + base + lam * x2 * x2;
      h33 = mu * (T(3) * x3 * x3 - T(1)) + base + lam * x3 * x3;
      h12 = lam * x1 * x2;
      h13 = lam * x1 * x3;
      h23 = lam * x2 * x3;
    }
    const T hmax = vmax(vmax(fabs(h11), fabs(h22)),
                        vmax(fabs(h33), vmax(fabs(h12), vmax(fabs(h13), fabs(h23)))));
    const T damp = T(1e-6) * (hmax + T(1));
    h11 = h11 + damp;
    h22 = h22 + damp;
    h33 = h33 + damp;
    // symmetric 3x3 solve via the adjugate
    const T cof11 = h22 * h33 - h23 * h23;
    const T cof12 = h13 * h23 - h12 * h33;
    const T cof13 = h12 * h23 - h13 * h22;
    T det = h11 * cof11 + h12 * cof12 + h13 * cof13;
    det = fabs(det) > T(1e-30) ? det : T(1);
    const T cof22 = h11 * h33 - h13 * h13;
    const T cof23 = h12 * h13 - h11 * h23;
    const T cof33 = h11 * h22 - h12 * h12;
    T d1 = -(cof11 * g1 + cof12 * g2 + cof13 * g3) / det;
    T d2 = -(cof12 * g1 + cof22 * g2 + cof23 * g3) / det;
    T d3 = -(cof13 * g1 + cof23 * g2 + cof33 * g3) / det;
    // steepest-descent fallback if not a descent direction
    const bool descent = d1 * g1 + d2 * g2 + d3 * g3 < T(0);
    const T gscale = T(1) / (hmax + T(1));
    d1 = descent ? d1 : -g1 * gscale;
    d2 = descent ? d2 : -g2 * gscale;
    d3 = descent ? d3 : -g3 * gscale;

    T f_best = value<T, MODEL>(x1, x2, x3, mu, lam, k, c1, c2, c3);
    T b1 = x1, b2 = x2, b3 = x3;
    // ladder order matters: nh_local._ALPHAS, then _GRAD_ALPHAS
    const T alphas[6] = {T(1.0), T(0.5), T(0.25), T(0.0625), T(1.0 / 64.0),
                         T(1.0 / 256.0)};
#pragma unroll
    for (int a = 0; a < 6; ++a)
      try_step<T, MODEL>(x1 + alphas[a] * d1, x2 + alphas[a] * d2,
                         x3 + alphas[a] * d3, mu, lam, k, c1, c2, c3, f_best,
                         b1, b2, b3);
    const T galphas[2] = {T(1.0), T(0.0625)};
#pragma unroll
    for (int a = 0; a < 2; ++a)
      try_step<T, MODEL>(x1 - galphas[a] * g1 * gscale,
                         x2 - galphas[a] * g2 * gscale,
                         x3 - galphas[a] * g3 * gscale, mu, lam, k, c1, c2,
                         c3, f_best, b1, b2, b3);
    x1 = b1;
    x2 = b2;
    x3 = b3;
  }
}

// Warm-start guards (TetForce.cpp:339-347): neg3 is read before the abs;
// the collapsed bump applies only when the third was non-negative.
template <typename T>
__device__ __forceinline__ void warm_guard(T& w1, T& w2, T w3raw, T& w3) {
  const bool neg3 = w3raw < T(0);
  w3 = fabs(w3raw);
  const bool collapsed = (!neg3) && (fabs(w1) < T(1e-3)) &&
                         (fabs(w2) < T(1e-3)) && (fabs(w3) < T(1e-3));
  w1 = collapsed ? T(1e-3) : w1;
  w2 = collapsed ? T(1e-3) : w2;
  w3 = collapsed ? T(1e-3) : w3;
}

}  // namespace hyper
}  // namespace admm
