// Fused triangle-strain (cloth) local step for Hopper.
//
// Replaces: admm_elastic_tpu/ops/pallas/tri_local.py, tri_local_step_fused
// (kernel _make_tri_fused_kernel, without emit_z). The projection is the
// shared device code of tri.cuh.
//
// Per element: F = sum_k cp*xg + u (3x2) -> closed-form 3x2 SVD -> z = (k
// U V^T + w2 F) / (w2 + k), column norms clamped into [lmin, lmax] ->
// u' = F - z, and the RHS rows contrib[3k+j] = w2 * sum_r cp[3r+k] *
// (z - u')[2j+r].
//
// What bounds it on this card: bytes. Each element reads 9 + 6 + 6 + 4
// values and writes 6 + 6 + 9 (184 bytes in f32, ~18.6 MB at the cloth100k
// sheet's 101,250 triangles) against a few hundred flops and five square
// roots; the arrays are L2-sized (50 MB).
//
// Design: one thread per element, everything in registers, no shared
// memory. Arrays are plane-major (P, E), so neighbouring threads read
// neighbouring addresses. Built without fast math and without FMA
// contraction (ops/kernels/_build.py), so it equals the plain PyTorch
// version bitwise where both use correctly rounded sqrt and division.

#include "tri.cuh"

namespace admm {
namespace tri {

template <typename T>
__global__ void __launch_bounds__(128)
    fused_kernel(const T* __restrict__ xg, const T* __restrict__ u,
                 const T* __restrict__ cp, const T* __restrict__ w2_,
                 const T* __restrict__ k_, const T* __restrict__ lmin_,
                 const T* __restrict__ lmax_, T* __restrict__ z_out,
                 T* __restrict__ u_out, T* __restrict__ contrib, int E,
                 int limiting) {
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
    for (int j = 0; j < 3; ++j)
      contrib[(3 * kk + j) * sE + e] =
          w2 * (c[kk] * zu[2 * j] + c[3 + kk] * zu[2 * j + 1]);
}

template <typename T>
int launch(const T* xg, const T* u, const T* cp, const T* w2, const T* k,
           const T* lmin, const T* lmax, T* z, T* u_out, T* contrib, int E,
           int limiting, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  constexpr int threads = 128;
  const int blocks = (E + threads - 1) / threads;
  fused_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      xg, u, cp, w2, k, lmin, lmax, z, u_out, contrib, E, limiting);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tri
}  // namespace admm

extern "C" {

// limiting: 0 or 1 (strain limiting on). Returns the cudaError_t of the
// launch.
int tri_local_step_fused_f32(const float* xg, const float* u, const float* cp,
                             const float* w2, const float* k,
                             const float* lmin, const float* lmax, float* z,
                             float* u_out, float* contrib, int E,
                             int limiting, void* stream) {
  return admm::tri::launch<float>(xg, u, cp, w2, k, lmin, lmax, z, u_out,
                                  contrib, E, limiting, stream);
}

int tri_local_step_fused_f64(const double* xg, const double* u,
                             const double* cp, const double* w2,
                             const double* k, const double* lmin,
                             const double* lmax, double* z, double* u_out,
                             double* contrib, int E, int limiting,
                             void* stream) {
  return admm::tri::launch<double>(xg, u, cp, w2, k, lmin, lmax, z, u_out,
                                   contrib, E, limiting, stream);
}

}  // extern "C"
