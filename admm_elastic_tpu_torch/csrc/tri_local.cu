// Triangle-strain (cloth) local step for Hopper: two entries.
//
// Replaces, in admm_elastic_tpu/ops/pallas/tri_local.py:
//   tri_local_step_fused (kernel _make_tri_fused_kernel), which forms F
//     from gathered positions and emits the RHS rows (the dia route), and
//     with emit_z the rows of w2 D^T z beside them (the dual residual's,
//     tri_local.py:158, 188-196);
//   tri_local_step (kernel _make_tri_kernel), which takes Dx (the unfused
//     pipeline: dense and cg global modes, over-relaxation).
// The projection is the shared device code of tri.cuh.
//
// Per element: F = Dx + u (3x2; Dx = sum_k cp*xg in the fused entry) ->
// closed-form 3x2 SVD -> z = (k U V^T + w2 F) / (w2 + k), column norms
// clamped into [lmin, lmax] -> u' = F - z, and (fused only) the RHS rows
// contrib[3k+j] = w2 * sum_r cp[3r+k] * (z - u')[2j+r]; with emit_z (a
// compile-time mode, EMIT_Z) also contribz[3k+j] = w2 * sum_r cp[3r+k] *
// z[2j+r].
//
// What bounds it on this card: bytes. The fused entry reads 9 + 6 + 6 + 4
// values per element and writes 6 + 6 + 9 (184 bytes in f32, ~18.6 MB at
// the cloth100k sheet's 101,250 triangles), the unfused one reads 6 + 6 + 4
// and writes 6 + 6 (112 bytes), against a few hundred flops and five
// square roots; the arrays are L2-sized (50 MB).
//
// Design: one thread per element, everything in registers, no shared
// memory. Arrays are plane-major (P, E), so neighbouring threads read
// neighbouring addresses. Built without fast math and without FMA
// contraction (ops/kernels/_build.py), so it equals the plain PyTorch
// version bitwise where both use correctly rounded sqrt and division.

#include "tri.cuh"

namespace admm {
namespace tri {

template <typename T, bool EMIT_Z>
__global__ void __launch_bounds__(128)
    fused_kernel(const T* __restrict__ xg, const T* __restrict__ u,
                 const T* __restrict__ cp, const T* __restrict__ w2_,
                 const T* __restrict__ k_, const T* __restrict__ lmin_,
                 const T* __restrict__ lmax_, T* __restrict__ z_out,
                 T* __restrict__ u_out, T* __restrict__ contrib,
                 T* __restrict__ contribz, int E, int limiting) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t sE = static_cast<size_t>(E);
  T x[9], c[6], f[6];
#pragma unroll
  for (int p = 0; p < 9; ++p) x[p] = xg[p * sE + e];
#pragma unroll
  for (int p = 0; p < 6; ++p) c[p] = cp[p * sE + e];
  // f[2a+b] = F_{a,b} = sum_k cp[3b+k] * xg[3k+a] + u[2a+b]
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      T acc = c[3 * b] * x[a];
      acc = acc + c[3 * b + 1] * x[3 + a];
      acc = acc + c[3 * b + 2] * x[6 + a];
      f[2 * a + b] = acc + u[(2 * a + b) * sE + e];
    }

  const T w2 = w2_[e], k = k_[e];
  T z[6];
  tri_body<T>(f, w2, k, T(1) / (w2 + k), lmin_[e], lmax_[e], limiting != 0,
              z);

  T zu[6];
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const T un = f[p] - z[p];
    z_out[p * sE + e] = z[p];
    u_out[p * sE + e] = un;
    zu[p] = z[p] - un;  // = 2z - F
  }
#pragma unroll
  for (int kk = 0; kk < 3; ++kk)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      contrib[(3 * kk + j) * sE + e] =
          w2 * (c[kk] * zu[2 * j] + c[3 + kk] * zu[2 * j + 1]);
      if constexpr (EMIT_Z)
        contribz[(3 * kk + j) * sE + e] =
            w2 * (c[kk] * z[2 * j] + c[3 + kk] * z[2 * j + 1]);
    }
}

template <typename T>
__global__ void __launch_bounds__(128)
    step_kernel(const T* __restrict__ dx, const T* __restrict__ u,
                const T* __restrict__ w2_, const T* __restrict__ k_,
                const T* __restrict__ lmin_, const T* __restrict__ lmax_,
                T* __restrict__ z_out, T* __restrict__ u_out, int E,
                int limiting) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t sE = static_cast<size_t>(E);
  T f[6];
#pragma unroll
  for (int p = 0; p < 6; ++p) f[p] = dx[p * sE + e] + u[p * sE + e];
  const T w2 = w2_[e], k = k_[e];
  T z[6];
  tri_body<T>(f, w2, k, T(1) / (w2 + k), lmin_[e], lmax_[e], limiting != 0,
              z);
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    z_out[p * sE + e] = z[p];
    u_out[p * sE + e] = f[p] - z[p];
  }
}

constexpr int kThreads = 128;

inline int blocks_for(int E) { return (E + kThreads - 1) / kThreads; }

template <typename T>
int launch_fused(const T* xg, const T* u, const T* cp, const T* w2,
                 const T* k, const T* lmin, const T* lmax, T* z, T* u_out,
                 T* contrib, T* contribz, int E, int limiting,
                 void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (contribz != nullptr)
    fused_kernel<T, true><<<blocks_for(E), kThreads, 0, st>>>(
        xg, u, cp, w2, k, lmin, lmax, z, u_out, contrib, contribz, E,
        limiting);
  else
    fused_kernel<T, false><<<blocks_for(E), kThreads, 0, st>>>(
        xg, u, cp, w2, k, lmin, lmax, z, u_out, contrib, contribz, E,
        limiting);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_step(const T* dx, const T* u, const T* w2, const T* k,
                const T* lmin, const T* lmax, T* z, T* u_out, int E,
                int limiting, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  step_kernel<T><<<blocks_for(E), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      dx, u, w2, k, lmin, lmax, z, u_out, E, limiting);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tri
}  // namespace admm

extern "C" {

// limiting: 0 or 1 (strain limiting on). contribz: the emit_z rows (9,E),
// or null for the entry without them. Each returns the cudaError_t of the
// launch.
int tri_local_step_fused_f32(const float* xg, const float* u, const float* cp,
                             const float* w2, const float* k,
                             const float* lmin, const float* lmax, float* z,
                             float* u_out, float* contrib, float* contribz,
                             int E, int limiting, void* stream) {
  return admm::tri::launch_fused<float>(xg, u, cp, w2, k, lmin, lmax, z,
                                        u_out, contrib, contribz, E, limiting,
                                        stream);
}

int tri_local_step_fused_f64(const double* xg, const double* u,
                             const double* cp, const double* w2,
                             const double* k, const double* lmin,
                             const double* lmax, double* z, double* u_out,
                             double* contrib, double* contribz, int E,
                             int limiting, void* stream) {
  return admm::tri::launch_fused<double>(xg, u, cp, w2, k, lmin, lmax, z,
                                         u_out, contrib, contribz, E,
                                         limiting, stream);
}

int tri_local_step_f32(const float* dx, const float* u, const float* w2,
                       const float* k, const float* lmin, const float* lmax,
                       float* z, float* u_out, int E, int limiting,
                       void* stream) {
  return admm::tri::launch_step<float>(dx, u, w2, k, lmin, lmax, z, u_out, E,
                                       limiting, stream);
}

int tri_local_step_f64(const double* dx, const double* u, const double* w2,
                       const double* k, const double* lmin,
                       const double* lmax, double* z, double* u_out, int E,
                       int limiting, void* stream) {
  return admm::tri::launch_step<double>(dx, u, w2, k, lmin, lmax, z, u_out,
                                        E, limiting, stream);
}

}  // extern "C"
