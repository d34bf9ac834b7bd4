// Fused hyperelastic tet local step (NeoHookean / StVK) for Hopper.
//
// Replaces: admm_elastic_tpu/ops/pallas/nh_local.py, nh_local_step_fused
// (kernel _make_hyper_fused_kernel). The SVD, Newton prox and warm-start
// guards are the shared device functions of hyper.cuh.
//
// Per element: F = sum_k cp*xg + u -> oriented 3x3 SVD (6 Jacobi sweeps on
// F^T F) -> damped Newton on sigma for the proximal objective (fixed
// iterations, backtracking ladder + gradient candidates, sigma floor) ->
// z = U diag(sigma*) V^T, u' = u + Dx - z, warm start sigma*, and the RHS
// rows contrib[3k+j] = w2 * sum_r cp[4r+k] * (z - u')[3j+r].
//
// What bounds it on this card: registers and the ALU. Each element reads
// 12+9+3+12+4 values and writes 9+9+3+12 (about 290 bytes in f32) but runs
// a few thousand dependent flops, including ~40 logs and ~60 divisions; at
// 100,000 elements the arrays sit in the 50 MB L2.
//
// Design: one thread per element, everything in registers, no shared
// memory. Arrays are plane-major (P, E), so neighbouring threads read
// neighbouring addresses. Every loop over planes, sweeps and candidates has
// a compile-time trip count and unrolls into straight-line code; only the
// Newton iteration count is a runtime loop. The arithmetic is a literal
// transcription of the Pallas math, in the same order, built without fast
// math and without FMA contraction (see ops/kernels/_build.py), so it
// agrees with the plain PyTorch version to round-off of log/sqrt.

#include "hyper.cuh"

namespace admm {
namespace nh {

using hyper::newton_hyper;
using hyper::svd_columns;
using hyper::warm_guard;

template <typename T, int MODEL>
__global__ void __launch_bounds__(128)
    fused_kernel(const T* __restrict__ xg, const T* __restrict__ u,
                 const T* __restrict__ warm, const T* __restrict__ cp,
                 const T* __restrict__ mu_, const T* __restrict__ lam_,
                 const T* __restrict__ k_, const T* __restrict__ w2_,
                 T* __restrict__ z_out, T* __restrict__ u_out,
                 T* __restrict__ warm_out, T* __restrict__ contrib, int E,
                 int iters) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t sE = static_cast<size_t>(E);
  T x[12], c[12], uu[9];
#pragma unroll
  for (int p = 0; p < 12; ++p) {
    x[p] = xg[p * sE + e];
    c[p] = cp[p * sE + e];
  }
#pragma unroll
  for (int p = 0; p < 9; ++p) uu[p] = u[p * sE + e];

  // dx[3a+b] = F_{a,b} = sum_k cp[4b+k] * xg[3k+a]
  T dx[9], f[9];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      T acc = c[4 * b] * x[a];
#pragma unroll
      for (int kk = 1; kk < 4; ++kk) acc = acc + c[4 * b + kk] * x[3 * kk + a];
      dx[3 * a + b] = acc;
    }
#pragma unroll
  for (int p = 0; p < 9; ++p) f[p] = dx[p] + uu[p];

  T U[3][3], V[3][3], s[3];
  svd_columns<T>(f, Limits<T>::eps(), U, V, s);

  T w1 = warm[e], w2 = warm[sE + e], w3;
  warm_guard(w1, w2, warm[2 * sE + e], w3);

  newton_hyper<T, MODEL>(s, w1, w2, w3, mu_[e], lam_[e], k_[e], iters);
  warm_out[e] = w1;
  warm_out[sE + e] = w2;
  warm_out[2 * sE + e] = w3;

  const T sig[3] = {w1, w2, w3};
  T zu[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      const T z = U[0][r] * sig[0] * V[0][cc] + U[1][r] * sig[1] * V[1][cc] +
                  U[2][r] * sig[2] * V[2][cc];
      const T un = uu[3 * r + cc] + dx[3 * r + cc] - z;
      z_out[(3 * r + cc) * sE + e] = z;
      u_out[(3 * r + cc) * sE + e] = un;
      zu[3 * r + cc] = z - un;
    }

  const T w2e = w2_[e];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T acc = c[kk] * zu[3 * j];
#pragma unroll
      for (int r = 1; r < 3; ++r) acc = acc + c[4 * r + kk] * zu[3 * j + r];
      contrib[(3 * kk + j) * sE + e] = w2e * acc;
    }
}

template <typename T>
int launch(const T* xg, const T* u, const T* warm, const T* cp, const T* mu,
           const T* lam, const T* k, const T* w2, T* z, T* u_out, T* warm_out,
           T* contrib, int E, int iters, int model, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  constexpr int threads = 128;
  const int blocks = (E + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (model == 0)
    fused_kernel<T, 0><<<blocks, threads, 0, st>>>(
        xg, u, warm, cp, mu, lam, k, w2, z, u_out, warm_out, contrib, E, iters);
  else
    fused_kernel<T, 1><<<blocks, threads, 0, st>>>(
        xg, u, warm, cp, mu, lam, k, w2, z, u_out, warm_out, contrib, E, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nh
}  // namespace admm

extern "C" {

// model: 0 = NeoHookean, 1 = StVK. Returns the cudaError_t of the launch.
int nh_local_step_fused_f32(const float* xg, const float* u, const float* warm,
                            const float* cp, const float* mu, const float* lam,
                            const float* k, const float* w2, float* z,
                            float* u_out, float* warm_out, float* contrib,
                            int E, int iters, int model, void* stream) {
  return admm::nh::launch<float>(xg, u, warm, cp, mu, lam, k, w2, z, u_out,
                                 warm_out, contrib, E, iters, model, stream);
}

int nh_local_step_fused_f64(const double* xg, const double* u,
                            const double* warm, const double* cp,
                            const double* mu, const double* lam,
                            const double* k, const double* w2, double* z,
                            double* u_out, double* warm_out, double* contrib,
                            int E, int iters, int model, void* stream) {
  return admm::nh::launch<double>(xg, u, warm, cp, mu, lam, k, w2, z, u_out,
                                  warm_out, contrib, E, iters, model, stream);
}

const char* admm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
