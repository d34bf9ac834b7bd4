// Corotational (ARAP) tet local step for Hopper: two entries.
//
// Replaces, in admm_elastic_tpu/ops/pallas/tet_local.py:
//   arap_local_step_fused (kernel _make_arap_fused_kernel), which forms Dx
//     from the positions and emits the RHS rows (the dia/ell route of
//     LinearTetStrain), and with emit_z the rows of w2 D^T z beside them
//     (the dual residual's, tet_local.py:195-198, 234-241);
//   arap_local_step (kernel _arap_kernel), which takes Dx (the unfused
//     pipeline: dense and cg global modes, over-relaxation).
// The element math is arap.cuh's.
//
// Per element: F = Dx + u (Dx[3a+b] = sum_k cp[4b+k] x[tet[k], a] in the
// fused entry) -> R = closest proper rotation to F -> z = (k R + w2 F) /
// (w2 + k), u' = u + Dx - z, and (fused only) the RHS rows
// rows[4e+k][j] = w2 * sum_r cp[4r+k] * (z - u')[3j+r]; with emit_z (a
// compile-time mode, EMIT_Z) the rows are 6 wide and
// rows[4e+k][3+j] = w2 * sum_r cp[4r+k] * z[3j+r].
//
// The fused entry gathers its four vertices itself, from x (n,3) through
// the tets (E,4) in int32, and writes the rows in the (4E, 3) or (4E, 6)
// layout the RHS's incidence gather reads (core/system.py _gather), as
// nh_local.cu does: the TPU kernel took gathered positions (12,E) and gave
// row planes (12,E), because a TPU kernel cannot gather; on this card x
// (22,386 nodes at arap100k, 269 KB in f32) stays in the 50 MB L2, and the
// caller's gather and its two transposing copies are gone. A warp stages
// its elements' rows in shared memory and writes them as one contiguous
// run.
//
// What bounds it on this card: instruction issue. An element is one long
// dependent chain (six Jacobi sweeps of a 3x3 symmetric matrix, 21 square
// roots and divisions, about a thousand flops), built without FMA
// contraction.
// By bytes the fused entry reads 16 (tets) + 9 + 12 + 2 values an element
// (positions from L2) and writes 9 + 9 + 12 (228 bytes in f32), the
// unfused one reads 9 + 9 + 2 and writes 9 + 9 (152 bytes). At 100,000
// elements the grid has 782 blocks of 128 threads: one wave only when an
// SM holds 6 of them, so the register count a thread decides the waves:
// in f32 the fused kernel takes 69 (80 with emit_z), the unfused 48, and
// a cap changes nothing; in f64 the fused one takes 118 (4 blocks an
// SM, two waves) and every cap that would fit more blocks spills and is
// slower. Each thread issues about 3,000 instructions (no FMA
// contraction, correctly rounded division and square root): at 100,000
// threads and one warp instruction a cycle a scheduler that is 9-11 us
// in f32, 75-90% of what the two kernels take.
//
// Design: one thread per element, everything in registers. Planes are
// plane-major (P, E), so neighbouring threads read neighbouring addresses.
// Built without fast math and without FMA contraction (ops/kernels/
// _build.py), so each entry equals its plain PyTorch twin bitwise. The
// fused kernel keeps the selector planes in registers through the
// rotation: reading them again from L2 after it (as nh_local.cu does, where
// registers are scarcer) took 3 more registers and was 3-5% slower. The
// kernels take the resident blocks an SM of their __launch_bounds__ (MINB)
// as a template argument: the other register caps are timed against the
// library's by utils/time_elements.py --force arap --designs
// (csrc/probes/arap_design_probe.cu), and the library builds the fastest
// that does not spill (kMinBlocks; PERF.md has the times).

#include "arap.cuh"

namespace admm {
namespace arap {

constexpr int kThreads = 128;
// The resident blocks an SM that ptxas makes the register allocation for:
// (128, 6) caps f32 at 85 registers (both kernels take fewer: E = 100,000
// in one wave), (128, 4) f64 at 128 (118 and 90: the same code as no cap);
// (128, 5) and more spill in f64 and are slower (PERF.md; utils/
// time_elements.py --force arap --designs).
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 6 : 4;

template <typename T, bool EMIT_Z, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    fused_kernel(const T* __restrict__ x, const int* __restrict__ tets,
                 const T* __restrict__ u, const T* __restrict__ cp,
                 const T* __restrict__ w2_, const T* __restrict__ k_,
                 T* __restrict__ z_out, T* __restrict__ u_out,
                 T* __restrict__ rows, int E) {
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

    const T w2 = w2_[e];
    T z[9], un[9], zu[9];
    element<T>(dx, uu, w2, k_[e], z, un);
#pragma unroll
    for (int p = 0; p < 9; ++p) {
      z_out[p * sE + e] = z[p];
      u_out[p * sE + e] = un[p];
      zu[p] = z[p] - un[p];
    }
    T* mine = st + lane * PITCH;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        T acc = c[kk] * zu[3 * j];
#pragma unroll
        for (int r = 1; r < 3; ++r) acc = acc + c[4 * r + kk] * zu[3 * j + r];
        mine[W * kk + j] = w2 * acc;
        if constexpr (EMIT_Z) {
          T accz = c[kk] * z[3 * j];
#pragma unroll
          for (int r = 1; r < 3; ++r)
            accz = accz + c[4 * r + kk] * z[3 * j + r];
          mine[W * kk + 3 + j] = w2 * accz;
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

template <typename T, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    step_kernel(const T* __restrict__ dx9, const T* __restrict__ u,
                const T* __restrict__ w2_, const T* __restrict__ k_,
                T* __restrict__ z_out, T* __restrict__ u_out, int E) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
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

inline int blocks_for(int E) { return (E + kThreads - 1) / kThreads; }

template <typename T, bool EMIT_Z, int MINB>
int fused_of(const T* x, const int* tets, const T* u, const T* cp,
             const T* w2, const T* k, T* z, T* u_out, T* rows, int E,
             cudaStream_t st) {
  fused_kernel<T, EMIT_Z, MINB><<<blocks_for(E), kThreads, 0, st>>>(
      x, tets, u, cp, w2, k, z, u_out, rows, E);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MINB>
int step_of(const T* dx, const T* u, const T* w2, const T* k, T* z,
            T* u_out, int E, cudaStream_t st) {
  step_kernel<T, MINB><<<blocks_for(E), kThreads, 0, st>>>(dx, u, w2, k, z,
                                                           u_out, E);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fused(const T* x, const int* tets, const T* u, const T* cp,
                 const T* w2, const T* k, T* z, T* u_out, T* rows, int E,
                 int emit_z, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int M = kMinBlocks<T>;
  return emit_z ? fused_of<T, true, M>(x, tets, u, cp, w2, k, z, u_out, rows,
                                       E, st)
                : fused_of<T, false, M>(x, tets, u, cp, w2, k, z, u_out,
                                        rows, E, st);
}

template <typename T>
int launch_step(const T* dx, const T* u, const T* w2, const T* k, T* z,
                T* u_out, int E, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  return step_of<T, kMinBlocks<T>>(dx, u, w2, k, z, u_out, E,
                                   static_cast<cudaStream_t>(stream));
}

}  // namespace arap
}  // namespace admm

extern "C" {

// tets: (E,4) int32, 16-byte aligned. rows: (4E,3), or (4E,6) with
// emit_z. Each returns the cudaError_t of the launch.
int arap_local_step_fused_f32(const float* x, const int* tets,
                              const float* u, const float* cp,
                              const float* w2, const float* k, float* z,
                              float* u_out, float* rows, int E, int emit_z,
                              void* stream) {
  return admm::arap::launch_fused<float>(x, tets, u, cp, w2, k, z, u_out,
                                         rows, E, emit_z, stream);
}

int arap_local_step_fused_f64(const double* x, const int* tets,
                              const double* u, const double* cp,
                              const double* w2, const double* k, double* z,
                              double* u_out, double* rows, int E, int emit_z,
                              void* stream) {
  return admm::arap::launch_fused<double>(x, tets, u, cp, w2, k, z, u_out,
                                          rows, E, emit_z, stream);
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
