// Hyperelastic tet local step (NeoHookean / StVK) for Hopper: two entries.
//
// Replaces, in admm_elastic_tpu/ops/pallas/nh_local.py:
//   nh_local_step_fused (kernel _make_hyper_fused_kernel), which forms Dx
//     and emits the RHS rows (the dia/ell route), and with emit_z the rows
//     of w2 D^T z beside them (the dual residual's, nh_local.py:333-343,
//     406-414);
//   nh_local_step (kernel _make_hyper_kernel), which takes Dx (the unfused
//     pipeline: dense and cg global modes, over-relaxation).
// The SVD, Newton prox and warm-start guards are the shared device
// functions of hyper.cuh.
//
// Per element: F = Dx + u (Dx = sum_k cp*x[tet[k]] in the fused entry) ->
// oriented 3x3 SVD (6 Jacobi sweeps on F^T F) -> damped Newton on sigma
// for the proximal objective (fixed iterations, backtracking ladder +
// gradient candidates, sigma floor) -> z = U diag(sigma*) V^T,
// u' = u + Dx - z, warm start sigma*, and (fused only) the RHS rows
// rows[4e+k][j] = w2 * sum_r cp[4r+k] * (z - u')[3j+r]; with emit_z the
// rows are 6 wide and rows[4e+k][3+j] = w2 * sum_r cp[4r+k] * z[3j+r], a
// compile-time mode (EMIT_Z): the instantiation without it does none of
// that work.
//
// The fused entry gathers its four vertices itself, from x (n,3) through
// the tets (E,4) in int32, and writes the rows in the (4E, 3) or (4E, 6)
// layout the RHS's incidence gather reads (core/system.py _gather): the
// TPU kernel took gathered positions (12,E) and gave row planes (12,E),
// because a TPU kernel cannot gather; on this card x (22,386 nodes at
// tet100k, 269 KB in f32) stays in the 50 MB L2, and the caller's gather
// and its two transposing copies are gone. A warp stages its elements'
// rows in shared memory and writes them as one contiguous run.
//
// What bounds it on this card: the issue rate and the latency of long
// dependent chains. The fused entry reads 12+9+3+12+4 values per element
// (positions from L2) and writes 9+9+3+12 (about 290 bytes in f32), the
// unfused one reads 9+9+3+3 and writes 9+9+3 (180 bytes); each runs a few
// thousand dependent flops (6 Jacobi sweeps of divisions and square roots,
// then 5 Newton iterations of 9 objective values with a log each), built
// without FMA contraction: about 2x the issue floor on the device. At
// 100,000 elements the grid has 782 blocks of 128 threads: one wave in f32
// when an SM holds 6 of them (at most 85 registers a thread), two in f64
// (3 an SM at most 170). Tensor cores, TMA and clusters have no place
// here: there is no matrix product, and each element's 180-290 bytes are
// read once and used once.
//
// Design: one thread per element, everything in registers. Planes are
// plane-major (P, E), so neighbouring threads read neighbouring addresses.
// Every loop over planes, sweeps and candidates has a compile-time trip
// count and unrolls into straight-line code; only the Newton iteration
// count is a runtime loop. The arithmetic is a literal transcription of
// the Pallas math, in the same order, built without fast math and without
// FMA contraction (see ops/kernels/_build.py), so each entry equals its
// plain PyTorch twin bitwise. The kernels take the resident blocks an SM
// of their __launch_bounds__ (MINB) as a template argument: the other
// register caps are timed against the library's by
// utils/time_elements.py --designs (csrc/probes/nh_design_probe.cu), and
// the library builds the fastest that does not spill (kMinBlocks; PERF.md
// has the times, and those of a Newton ladder split over two lanes, which
// was slower and is not kept).

#include "hyper.cuh"

namespace admm {
namespace nh {

using hyper::newton_hyper;
using hyper::svd_columns;
using hyper::warm_guard;

constexpr int kThreads = 128;
// The resident blocks an SM that ptxas makes the register allocation for.
// (128, 6) caps f32 at 85 registers (80 used: 6 blocks an SM, E = 100,000
// in one wave), (128, 3) f64 at 170 (164-166): neither spills. Without a
// cap ptxas takes 111-115 (f32) and 196-198 (f64) registers, 8-12% slower
// (PERF.md; utils/time_elements.py --designs).
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 6 : 3;

// The element step shared by both entries: z, u' = u + Dx - z and the new
// warm start (w: the old one in, the new one out) from Dx and u.
template <typename T, int MODEL>
__device__ __forceinline__ void element(const T dx[9], const T uu[9], T w[3],
                                        T mu, T lam, T k, int iters, T z[9],
                                        T un[9]) {
  T f[9];
#pragma unroll
  for (int p = 0; p < 9; ++p) f[p] = dx[p] + uu[p];

  T U[3][3], V[3][3], s[3];
  svd_columns<T>(f, Limits<T>::eps(), U, V, s);

  T w1 = w[0], w2 = w[1], w3;
  warm_guard(w1, w2, w[2], w3);
  newton_hyper<T, MODEL>(s, w1, w2, w3, mu, lam, k, iters);
  w[0] = w1;
  w[1] = w2;
  w[2] = w3;

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

// z, u' and the warm start to their planes.
template <typename T>
__device__ __forceinline__ void store_planes(const T z[9], const T un[9],
                                             const T w[3], size_t sE, int e,
                                             T* __restrict__ z_out,
                                             T* __restrict__ u_out,
                                             T* __restrict__ warm_out) {
#pragma unroll
  for (int p = 0; p < 9; ++p) z_out[p * sE + e] = z[p];
#pragma unroll
  for (int p = 0; p < 3; ++p) warm_out[p * sE + e] = w[p];
#pragma unroll
  for (int p = 0; p < 9; ++p) u_out[p * sE + e] = un[p];
}

template <typename T, int MODEL, bool EMIT_Z, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    fused_kernel(const T* __restrict__ x, const int* __restrict__ tets,
                 const T* __restrict__ u, const T* __restrict__ warm,
                 const T* __restrict__ cp, const T* __restrict__ mu_,
                 const T* __restrict__ lam_, const T* __restrict__ k_,
                 const T* __restrict__ w2_, T* __restrict__ z_out,
                 T* __restrict__ u_out, T* __restrict__ warm_out,
                 T* __restrict__ rows, int E, int iters) {
  constexpr int W = EMIT_Z ? 6 : 3;  // the width of a row
  constexpr int W4 = 4 * W;          // an element's values in rows
  constexpr int PITCH = W4 + 1;      // odd: no bank conflicts in f32
  __shared__ T stage[kThreads / 32][32 * PITCH];

  const int e = blockIdx.x * kThreads + threadIdx.x, lane = threadIdx.x & 31;
  T* st = stage[threadIdx.x >> 5];
  if (e < E) {
    const size_t sE = static_cast<size_t>(E);
    const int4 q = __ldg(reinterpret_cast<const int4*>(tets) + e);
    const int vid[4] = {q.x, q.y, q.z, q.w};
    T xv[12];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < 3; ++a)
        xv[3 * kk + a] = __ldg(x + 3 * static_cast<size_t>(vid[kk]) + a);
    T c[12], uu[9];
#pragma unroll
    for (int p = 0; p < 12; ++p) c[p] = __ldg(cp + p * sE + e);
#pragma unroll
    for (int p = 0; p < 9; ++p) uu[p] = u[p * sE + e];

    // dx[3a+b] = F_{a,b} = sum_k cp[4b+k] * x[tet[k], a]
    T dx[9];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        T acc = c[4 * b] * xv[a];
#pragma unroll
        for (int kk = 1; kk < 4; ++kk)
          acc = acc + c[4 * b + kk] * xv[3 * kk + a];
        dx[3 * a + b] = acc;
      }

    T w[3] = {warm[e], warm[sE + e], warm[2 * sE + e]};
    T z[9], un[9];
    element<T, MODEL>(dx, uu, w, mu_[e], lam_[e], k_[e], iters, z, un);
    store_planes<T>(z, un, w, sE, e, z_out, u_out, warm_out);

    T zu[9];
#pragma unroll
    for (int p = 0; p < 9; ++p) zu[p] = z[p] - un[p];
    // the selector planes again: reading them from L2 here is cheaper
    // than keeping 12 registers through the prox
#pragma unroll
    for (int p = 0; p < 12; ++p) c[p] = __ldcg(cp + p * sE + e);
    const T w2e = w2_[e];
    T* mine = st + lane * PITCH;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        T acc = c[kk] * zu[3 * j];
#pragma unroll
        for (int r = 1; r < 3; ++r) acc = acc + c[4 * r + kk] * zu[3 * j + r];
        mine[W * kk + j] = w2e * acc;
        if constexpr (EMIT_Z) {
          T accz = c[kk] * z[3 * j];
#pragma unroll
          for (int r = 1; r < 3; ++r)
            accz = accz + c[4 * r + kk] * z[3 * j + r];
          mine[W * kk + 3 + j] = w2e * accz;
        }
      }
  }
  // the warp's elements' rows are one run of rows: written coalesced
  __syncwarp();
  const int e0 = blockIdx.x * kThreads + (threadIdx.x & ~31);
  const int n_vals = W4 * min(32, E - e0);
  T* out = rows + static_cast<size_t>(e0) * W4;
  for (int i = lane; i < n_vals; i += 32) {
    const int j = i / W4;
    out[i] = st[j * PITCH + (i - j * W4)];
  }
}

template <typename T, int MODEL, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    step_kernel(const T* __restrict__ dx9, const T* __restrict__ u,
                const T* __restrict__ warm, const T* __restrict__ mu_,
                const T* __restrict__ lam_, const T* __restrict__ k_,
                T* __restrict__ z_out, T* __restrict__ u_out,
                T* __restrict__ warm_out, int E, int iters) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  const size_t sE = static_cast<size_t>(E);
  T dx[9], uu[9];
#pragma unroll
  for (int p = 0; p < 9; ++p) {
    dx[p] = dx9[p * sE + e];
    uu[p] = u[p * sE + e];
  }
  T w[3] = {warm[e], warm[sE + e], warm[2 * sE + e]};
  T z[9], un[9];
  element<T, MODEL>(dx, uu, w, mu_[e], lam_[e], k_[e], iters, z, un);
  store_planes<T>(z, un, w, sE, e, z_out, u_out, warm_out);
}

inline int blocks_for(int E) { return (E + kThreads - 1) / kThreads; }

template <typename T, int MODEL, bool EMIT_Z, int MINB>
int fused_of(const T* x, const int* tets, const T* u, const T* warm,
             const T* cp, const T* mu, const T* lam, const T* k, const T* w2,
             T* z, T* u_out, T* warm_out, T* rows, int E, int iters,
             cudaStream_t st) {
  fused_kernel<T, MODEL, EMIT_Z, MINB><<<blocks_for(E), kThreads, 0, st>>>(
      x, tets, u, warm, cp, mu, lam, k, w2, z, u_out, warm_out, rows, E,
      iters);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODEL, int MINB>
int step_of(const T* dx, const T* u, const T* warm, const T* mu,
            const T* lam, const T* k, T* z, T* u_out, T* warm_out, int E,
            int iters, cudaStream_t st) {
  step_kernel<T, MODEL, MINB><<<blocks_for(E), kThreads, 0, st>>>(
      dx, u, warm, mu, lam, k, z, u_out, warm_out, E, iters);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fused(const T* x, const int* tets, const T* u, const T* warm,
                 const T* cp, const T* mu, const T* lam, const T* k,
                 const T* w2, T* z, T* u_out, T* warm_out, T* rows, int E,
                 int iters, int model, int emit_z, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int M = kMinBlocks<T>;
  if (model == 0)
    return emit_z ? fused_of<T, 0, true, M>(x, tets, u, warm, cp, mu, lam, k,
                                            w2, z, u_out, warm_out, rows, E,
                                            iters, st)
                  : fused_of<T, 0, false, M>(x, tets, u, warm, cp, mu, lam, k,
                                             w2, z, u_out, warm_out, rows, E,
                                             iters, st);
  return emit_z ? fused_of<T, 1, true, M>(x, tets, u, warm, cp, mu, lam, k,
                                          w2, z, u_out, warm_out, rows, E,
                                          iters, st)
                : fused_of<T, 1, false, M>(x, tets, u, warm, cp, mu, lam, k,
                                           w2, z, u_out, warm_out, rows, E,
                                           iters, st);
}

template <typename T>
int launch_step(const T* dx, const T* u, const T* warm, const T* mu,
                const T* lam, const T* k, T* z, T* u_out, T* warm_out, int E,
                int iters, int model, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int M = kMinBlocks<T>;
  if (model == 0)
    return step_of<T, 0, M>(dx, u, warm, mu, lam, k, z, u_out, warm_out, E,
                            iters, st);
  return step_of<T, 1, M>(dx, u, warm, mu, lam, k, z, u_out, warm_out, E,
                          iters, st);
}

}  // namespace nh
}  // namespace admm

extern "C" {

// model: 0 = NeoHookean, 1 = StVK. tets: (E,4) int32, 16-byte aligned.
// rows: (4E,3), or (4E,6) with emit_z. Each returns the cudaError_t of the
// launch.
int nh_local_step_fused_f32(const float* x, const int* tets, const float* u,
                            const float* warm, const float* cp,
                            const float* mu, const float* lam, const float* k,
                            const float* w2, float* z, float* u_out,
                            float* warm_out, float* rows, int E, int iters,
                            int model, int emit_z, void* stream) {
  return admm::nh::launch_fused<float>(x, tets, u, warm, cp, mu, lam, k, w2,
                                       z, u_out, warm_out, rows, E, iters,
                                       model, emit_z, stream);
}

int nh_local_step_fused_f64(const double* x, const int* tets,
                            const double* u, const double* warm,
                            const double* cp, const double* mu,
                            const double* lam, const double* k,
                            const double* w2, double* z, double* u_out,
                            double* warm_out, double* rows, int E, int iters,
                            int model, int emit_z, void* stream) {
  return admm::nh::launch_fused<double>(x, tets, u, warm, cp, mu, lam, k, w2,
                                        z, u_out, warm_out, rows, E, iters,
                                        model, emit_z, stream);
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
