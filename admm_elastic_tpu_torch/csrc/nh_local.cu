// Hyperelastic tet local step (NeoHookean / StVK) for Hopper: two entries.
//
// Replaces, in admm_elastic_tpu/ops/pallas/nh_local.py:
//   nh_local_step_fused (kernel _make_hyper_fused_kernel), which forms Dx
//     from gathered positions and emits the RHS rows (the dia/ell route),
//     and with emit_z the rows of w2 D^T z beside them (the dual
//     residual's, nh_local.py:333-343, 406-414);
//   nh_local_step (kernel _make_hyper_kernel), which takes Dx (the unfused
//     pipeline: dense and cg global modes, over-relaxation).
// The SVD, Newton prox and warm-start guards are the shared device
// functions of hyper.cuh.
//
// Per element: F = Dx + u (Dx = sum_k cp*xg in the fused entry) -> oriented
// 3x3 SVD (6 Jacobi sweeps on F^T F) -> damped Newton on sigma for the
// proximal objective (fixed iterations, backtracking ladder + gradient
// candidates, sigma floor) -> z = U diag(sigma*) V^T, u' = u + Dx - z, warm
// start sigma*, and (fused only) the RHS rows contrib[3k+j] = w2 * sum_r
// cp[4r+k] * (z - u')[3j+r]; with emit_z also contribz[3k+j] = w2 * sum_r
// cp[4r+k] * z[3j+r], a compile-time mode (EMIT_Z): the instantiation
// without it does none of that work.
//
// What bounds it on this card: registers and the ALU. The fused entry
// reads 12+9+3+12+4 values per element and writes 9+9+3+12 (about 290
// bytes in f32), the unfused one reads 9+9+3+3 and writes 9+9+3 (180
// bytes), but each runs a few thousand dependent flops, including ~40 logs
// and ~60 divisions; at 100,000 elements the arrays sit in the 50 MB L2.
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

// The element step shared by both entries: z, u' = u + Dx - z and the new
// warm start (written to warm_out) from Dx, u and the old warm start.
template <typename T, int MODEL>
__device__ __forceinline__ void element(const T dx[9], const T uu[9],
                                        const T* __restrict__ warm,
                                        T* __restrict__ warm_out, T mu, T lam,
                                        T k, int iters, size_t sE, int e,
                                        T z[9], T un[9]) {
  T f[9];
#pragma unroll
  for (int p = 0; p < 9; ++p) f[p] = dx[p] + uu[p];

  T U[3][3], V[3][3], s[3];
  svd_columns<T>(f, Limits<T>::eps(), U, V, s);

  T w1 = warm[e], w2 = warm[sE + e], w3;
  warm_guard(w1, w2, warm[2 * sE + e], w3);

  newton_hyper<T, MODEL>(s, w1, w2, w3, mu, lam, k, iters);
  warm_out[e] = w1;
  warm_out[sE + e] = w2;
  warm_out[2 * sE + e] = w3;

  const T sig[3] = {w1, w2, w3};
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      z[3 * r + cc] = U[0][r] * sig[0] * V[0][cc] +
                      U[1][r] * sig[1] * V[1][cc] +
                      U[2][r] * sig[2] * V[2][cc];
      un[3 * r + cc] = uu[3 * r + cc] + dx[3 * r + cc] - z[3 * r + cc];
    }
}

template <typename T, int MODEL, bool EMIT_Z>
__global__ void __launch_bounds__(128)
    fused_kernel(const T* __restrict__ xg, const T* __restrict__ u,
                 const T* __restrict__ warm, const T* __restrict__ cp,
                 const T* __restrict__ mu_, const T* __restrict__ lam_,
                 const T* __restrict__ k_, const T* __restrict__ w2_,
                 T* __restrict__ z_out, T* __restrict__ u_out,
                 T* __restrict__ warm_out, T* __restrict__ contrib,
                 T* __restrict__ contribz, int E, int iters) {
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
  T dx[9];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      T acc = c[4 * b] * x[a];
#pragma unroll
      for (int kk = 1; kk < 4; ++kk) acc = acc + c[4 * b + kk] * x[3 * kk + a];
      dx[3 * a + b] = acc;
    }

  T z[9], un[9];
  element<T, MODEL>(dx, uu, warm, warm_out, mu_[e], lam_[e], k_[e], iters, sE,
                    e, z, un);
  T zu[9];
#pragma unroll
  for (int p = 0; p < 9; ++p) {
    z_out[p * sE + e] = z[p];
    u_out[p * sE + e] = un[p];
    zu[p] = z[p] - un[p];
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
      if constexpr (EMIT_Z) {
        T accz = c[kk] * z[3 * j];
#pragma unroll
        for (int r = 1; r < 3; ++r)
          accz = accz + c[4 * r + kk] * z[3 * j + r];
        contribz[(3 * kk + j) * sE + e] = w2e * accz;
      }
    }
}

template <typename T, int MODEL>
__global__ void __launch_bounds__(128)
    step_kernel(const T* __restrict__ dx9, const T* __restrict__ u,
                const T* __restrict__ warm, const T* __restrict__ mu_,
                const T* __restrict__ lam_, const T* __restrict__ k_,
                T* __restrict__ z_out, T* __restrict__ u_out,
                T* __restrict__ warm_out, int E, int iters) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t sE = static_cast<size_t>(E);
  T dx[9], uu[9];
#pragma unroll
  for (int p = 0; p < 9; ++p) {
    dx[p] = dx9[p * sE + e];
    uu[p] = u[p * sE + e];
  }
  T z[9], un[9];
  element<T, MODEL>(dx, uu, warm, warm_out, mu_[e], lam_[e], k_[e], iters, sE,
                    e, z, un);
#pragma unroll
  for (int p = 0; p < 9; ++p) {
    z_out[p * sE + e] = z[p];
    u_out[p * sE + e] = un[p];
  }
}

constexpr int kThreads = 128;

inline int blocks_for(int E) { return (E + kThreads - 1) / kThreads; }

template <typename T, int MODEL>
void fused_of(bool emit_z, const T* xg, const T* u, const T* warm,
              const T* cp, const T* mu, const T* lam, const T* k,
              const T* w2, T* z, T* u_out, T* warm_out, T* contrib,
              T* contribz, int E, int iters, cudaStream_t st) {
  if (emit_z)
    fused_kernel<T, MODEL, true><<<blocks_for(E), kThreads, 0, st>>>(
        xg, u, warm, cp, mu, lam, k, w2, z, u_out, warm_out, contrib,
        contribz, E, iters);
  else
    fused_kernel<T, MODEL, false><<<blocks_for(E), kThreads, 0, st>>>(
        xg, u, warm, cp, mu, lam, k, w2, z, u_out, warm_out, contrib,
        contribz, E, iters);
}

template <typename T>
int launch_fused(const T* xg, const T* u, const T* warm, const T* cp,
                 const T* mu, const T* lam, const T* k, const T* w2, T* z,
                 T* u_out, T* warm_out, T* contrib, T* contribz, int E,
                 int iters, int model, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool emit_z = contribz != nullptr;
  if (model == 0)
    fused_of<T, 0>(emit_z, xg, u, warm, cp, mu, lam, k, w2, z, u_out,
                   warm_out, contrib, contribz, E, iters, st);
  else
    fused_of<T, 1>(emit_z, xg, u, warm, cp, mu, lam, k, w2, z, u_out,
                   warm_out, contrib, contribz, E, iters, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_step(const T* dx, const T* u, const T* warm, const T* mu,
                const T* lam, const T* k, T* z, T* u_out, T* warm_out, int E,
                int iters, int model, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (model == 0)
    step_kernel<T, 0><<<blocks_for(E), kThreads, 0, st>>>(
        dx, u, warm, mu, lam, k, z, u_out, warm_out, E, iters);
  else
    step_kernel<T, 1><<<blocks_for(E), kThreads, 0, st>>>(
        dx, u, warm, mu, lam, k, z, u_out, warm_out, E, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nh
}  // namespace admm

extern "C" {

// model: 0 = NeoHookean, 1 = StVK. contribz: the emit_z rows (12,E), or
// null for the entry without them. Each returns the cudaError_t of the
// launch.
int nh_local_step_fused_f32(const float* xg, const float* u, const float* warm,
                            const float* cp, const float* mu, const float* lam,
                            const float* k, const float* w2, float* z,
                            float* u_out, float* warm_out, float* contrib,
                            float* contribz, int E, int iters, int model,
                            void* stream) {
  return admm::nh::launch_fused<float>(xg, u, warm, cp, mu, lam, k, w2, z,
                                       u_out, warm_out, contrib, contribz, E,
                                       iters, model, stream);
}

int nh_local_step_fused_f64(const double* xg, const double* u,
                            const double* warm, const double* cp,
                            const double* mu, const double* lam,
                            const double* k, const double* w2, double* z,
                            double* u_out, double* warm_out, double* contrib,
                            double* contribz, int E, int iters, int model,
                            void* stream) {
  return admm::nh::launch_fused<double>(xg, u, warm, cp, mu, lam, k, w2, z,
                                        u_out, warm_out, contrib, contribz, E,
                                        iters, model, stream);
}

int nh_local_step_f32(const float* dx, const float* u, const float* warm,
                      const float* mu, const float* lam, const float* k,
                      float* z, float* u_out, float* warm_out, int E,
                      int iters, int model, void* stream) {
  return admm::nh::launch_step<float>(dx, u, warm, mu, lam, k, z, u_out,
                                      warm_out, E, iters, model, stream);
}

int nh_local_step_f64(const double* dx, const double* u, const double* warm,
                      const double* mu, const double* lam, const double* k,
                      double* z, double* u_out, double* warm_out, int E,
                      int iters, int model, void* stream) {
  return admm::nh::launch_step<double>(dx, u, warm, mu, lam, k, z, u_out,
                                       warm_out, E, iters, model, stream);
}

const char* admm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
