// Corotational (ARAP) tet local step for Hopper: two entries.
//
// Replaces, in admm_elastic_tpu/ops/pallas/tet_local.py:
//   arap_local_step_fused (kernel _make_arap_fused_kernel), which forms Dx
//     from gathered positions and emits the RHS rows (the dia/ell route of
//     LinearTetStrain), and with emit_z the rows of w2 D^T z beside them
//     (the dual residual's, tet_local.py:195-198, 234-241);
//   arap_local_step (kernel _arap_kernel), which takes Dx (the unfused
//     pipeline: dense and cg global modes, over-relaxation).
// The element math is arap.cuh's.
//
// Per element: F = Dx + u (Dx[3a+b] = sum_k cp[4b+k] xg[3k+a] in the fused
// entry) -> R = closest proper rotation to F -> z = (k R + w2 F) / (w2 + k),
// u' = u + Dx - z, and (fused only) contrib[3k+j] = w2 * sum_r cp[4r+k] *
// (z - u')[3j+r]; with emit_z (a compile-time mode, EMIT_Z) also
// contribz[3k+j] = w2 * sum_r cp[4r+k] * z[3j+r].
//
// What bounds it on this card: bytes, nearly. The fused entry reads
// 12 + 9 + 12 + 2 values per element and writes 9 + 9 + 12 (260 bytes in
// f32, 26 MB at 100,000 tets), the unfused one reads 9 + 9 + 2 and writes
// 9 + 9 (152 bytes), against about a thousand flops (six Jacobi sweeps of
// a 3x3 symmetric matrix, 21 square roots and divisions).
//
// Design: one thread per element, everything in registers (the rotation
// keeps ~30 values live), no shared memory. Arrays are plane-major (P, E),
// so neighbouring threads read neighbouring addresses. Built without fast
// math and without FMA contraction (ops/kernels/_build.py), so it can equal
// its plain PyTorch twin bitwise.

#include "arap.cuh"

namespace admm {
namespace arap {

template <typename T, bool EMIT_Z>
__global__ void __launch_bounds__(128)
    fused_kernel(const T* __restrict__ xg, const T* __restrict__ u,
                 const T* __restrict__ cp, const T* __restrict__ w2_,
                 const T* __restrict__ k_, T* __restrict__ z_out,
                 T* __restrict__ u_out, T* __restrict__ contrib,
                 T* __restrict__ contribz, int E) {
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

  const T w2 = w2_[e];
  T z[9], un[9], zu[9];
  element<T>(dx, uu, w2, k_[e], z, un);
#pragma unroll
  for (int p = 0; p < 9; ++p) {
    z_out[p * sE + e] = z[p];
    u_out[p * sE + e] = un[p];
    zu[p] = z[p] - un[p];
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T acc = c[kk] * zu[3 * j];
#pragma unroll
      for (int r = 1; r < 3; ++r) acc = acc + c[4 * r + kk] * zu[3 * j + r];
      contrib[(3 * kk + j) * sE + e] = w2 * acc;
      if constexpr (EMIT_Z) {
        T accz = c[kk] * z[3 * j];
#pragma unroll
        for (int r = 1; r < 3; ++r)
          accz = accz + c[4 * r + kk] * z[3 * j + r];
        contribz[(3 * kk + j) * sE + e] = w2 * accz;
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(128)
    step_kernel(const T* __restrict__ dx9, const T* __restrict__ u,
                const T* __restrict__ w2_, const T* __restrict__ k_,
                T* __restrict__ z_out, T* __restrict__ u_out, int E) {
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
  element<T>(dx, uu, w2_[e], k_[e], z, un);
#pragma unroll
  for (int p = 0; p < 9; ++p) {
    z_out[p * sE + e] = z[p];
    u_out[p * sE + e] = un[p];
  }
}

constexpr int kThreads = 128;

inline int blocks_for(int E) { return (E + kThreads - 1) / kThreads; }

template <typename T>
int launch_fused(const T* xg, const T* u, const T* cp, const T* w2,
                 const T* k, T* z, T* u_out, T* contrib, T* contribz, int E,
                 void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (contribz != nullptr)
    fused_kernel<T, true><<<blocks_for(E), kThreads, 0, st>>>(
        xg, u, cp, w2, k, z, u_out, contrib, contribz, E);
  else
    fused_kernel<T, false><<<blocks_for(E), kThreads, 0, st>>>(
        xg, u, cp, w2, k, z, u_out, contrib, contribz, E);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_step(const T* dx, const T* u, const T* w2, const T* k, T* z,
                T* u_out, int E, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  step_kernel<T><<<blocks_for(E), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(dx, u, w2, k, z,
                                                        u_out, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace arap
}  // namespace admm

extern "C" {

// contribz: the emit_z rows (12,E), or null for the entry without them.
// Each returns the cudaError_t of the launch.
int arap_local_step_fused_f32(const float* xg, const float* u, const float* cp,
                              const float* w2, const float* k, float* z,
                              float* u_out, float* contrib, float* contribz,
                              int E, void* stream) {
  return admm::arap::launch_fused<float>(xg, u, cp, w2, k, z, u_out, contrib,
                                         contribz, E, stream);
}

int arap_local_step_fused_f64(const double* xg, const double* u,
                              const double* cp, const double* w2,
                              const double* k, double* z, double* u_out,
                              double* contrib, double* contribz, int E,
                              void* stream) {
  return admm::arap::launch_fused<double>(xg, u, cp, w2, k, z, u_out, contrib,
                                          contribz, E, stream);
}

int arap_local_step_f32(const float* dx, const float* u, const float* w2,
                        const float* k, float* z, float* u_out, int E,
                        void* stream) {
  return admm::arap::launch_step<float>(dx, u, w2, k, z, u_out, E, stream);
}

int arap_local_step_f64(const double* dx, const double* u, const double* w2,
                        const double* k, double* z, double* u_out, int E,
                        void* stream) {
  return admm::arap::launch_step<double>(dx, u, w2, k, z, u_out, E, stream);
}

}  // extern "C"
