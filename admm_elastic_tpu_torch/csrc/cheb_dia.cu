// A chunk of Chebyshev iterations with a sparse-DIAgonal matvec, in one
// persistent cooperative kernel, for Hopper.
//
// Replaces: admm_elastic_tpu/ops/pallas/cheb_dia.py, cheb_dia_chunk
// (kernel _make_kernel): n_it iterations of the dot-free Chebyshev
// recurrence of parallel/cheb.py on the Jacobi-preconditioned A_hat,
//   first: z = D^-1 (b - A x); d = inv_theta z      (else z, d as given)
//   n_it times: x += d; z -= D^-1 A d; d = c1[i] d + c2[i] z
//   last: x += d
// The sharded banded stepper runs a whole global solve of k iterations as
// one call (n_it = k - 1, first = last = true).
//
// Layout: vectors (n,3) row-major, invd (n,), dia (D,n) at vertex offsets
// (dia.cuh, reads past either end are 0), c1/c2 (n_it,) in device memory
// (the budget varies, so they are not __constant__). The Pallas kernel's
// (3*Lr,128) planes and lane rolls are TPU layout and are not carried
// over.
//
// The recurrence has no inner products: each iteration is one row-local
// pass over the vertices, and only the direction d is read across rows
// (by the matvec). With d double-buffered (iteration i reads buffer i%2
// and writes the other) one grid barrier per iteration suffices, after
// the init pass and between iterations: n_it barriers a launch (the PCG
// stages of coop_pcg.cuh need three). x and z stay row-local: a vertex
// keeps its thread in every pass, so they need no barrier.
//
// What bounds it on this card: at the 100k-tet beam (n = 22,386, 19
// diagonals) a pass reads ~2 MB (dia and the vectors), all L2-resident,
// and does ~133 operations per vertex, well under a microsecond of either
// rate; so the chain of grid barriers, a few microseconds a pass, bounds
// a call of 179 iterations (PERF.md).
//
// Design: grid = min(SMs x resident blocks, blocks needed for one vertex
// per thread), so every block is resident (grid.sync() is legal) and no
// block idles through a barrier with nothing to do; grid-stride loops;
// no thread returns early. Buffers written during the launch (x_out,
// z_out, the two d buffers) are never read through const __restrict__
// pointers. The arithmetic is the plain twin's (ops/kernels/cheb_dia.py)
// in its order, with no FMA contraction (--fmad=false), so the two agree
// bitwise.

#include <cooperative_groups.h>

#include "dia.cuh"

namespace admm {
namespace cheb {

namespace cgr = cooperative_groups;

constexpr int THREADS = 128;

template <typename T>
struct Args {
  const T* __restrict__ b;
  const T* __restrict__ x_in;
  const T* __restrict__ z_in;
  const T* __restrict__ d_in;
  const T* __restrict__ invd;
  const T* __restrict__ dia;
  const T* __restrict__ c1;
  const T* __restrict__ c2;
  T* x;      // x_out
  T* z;      // z_out
  T* d[2];   // iteration i reads d[i % 2], writes d[(i + 1) % 2]
  int n, D, n_it, first, last;
  T inv_theta;
  dia::Offsets offs;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) chunk_kernel(const Args<T> a) {
  cgr::grid_group grid = cgr::this_grid();
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gstride = gridDim.x * blockDim.x;

  for (int i = gtid; i < a.n; i += gstride) {
    const size_t q = 3 * static_cast<size_t>(i);
    T ax[3];
    if (a.first) dia::dia_row(a.dia, a.offs, a.D, a.n, i, a.x_in, ax);
    const T invd = a.invd[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.x[q + c] = a.x_in[q + c];
      if (a.first) {
        const T zc = invd * (a.b[q + c] - ax[c]);
        a.z[q + c] = zc;
        a.d[0][q + c] = a.inv_theta * zc;
      } else {
        a.z[q + c] = a.z_in[q + c];
        a.d[0][q + c] = a.d_in[q + c];
      }
    }
  }

  for (int it = 0; it < a.n_it; ++it) {
    grid.sync();
    const T* d = a.d[it & 1];
    T* dn = a.d[(it + 1) & 1];
    const T c1 = a.c1[it], c2 = a.c2[it];
    for (int i = gtid; i < a.n; i += gstride) {
      const size_t q = 3 * static_cast<size_t>(i);
      T ad[3];
      dia::dia_row(a.dia, a.offs, a.D, a.n, i, d, ad);
      const T invd = a.invd[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T dc = d[q + c];
        a.x[q + c] = a.x[q + c] + dc;
        const T zc = a.z[q + c] - invd * ad[c];
        a.z[q + c] = zc;
        dn[q + c] = c1 * dc + c2 * zc;
      }
    }
  }

  if (a.last) {
    const T* d = a.d[a.n_it & 1];
    for (int i = gtid; i < a.n; i += gstride) {
      const size_t q = 3 * static_cast<size_t>(i);
#pragma unroll
      for (int c = 0; c < 3; ++c) a.x[q + c] = a.x[q + c] + d[q + c];
    }
  }
}

// Blocks of the cooperative grid for n rows on the current device, or
// -cudaError_t.
template <typename T>
int grid_blocks(int n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chunk_kernel<T>, THREADS, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  const int needed = (n + THREADS - 1) / THREADS;
  return needed < sms * per_sm ? needed : sms * per_sm;
}

template <typename T>
int launch(const T* b, const T* x, const T* z, const T* d, const T* invd,
           const T* dia, const T* c1, const T* c2, T* x_out, T* z_out,
           T* d_out, T* d_tmp, const int* offsets, int n, int D, int n_it,
           int first, int last, double inv_theta, void* stream) {
  if (n < 1 || D < 1 || D > dia::MAX_DIAGONALS || n_it < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = grid_blocks<T>(n);
  if (blocks < 0) return -blocks;
  Args<T> a{};
  a.b = b; a.x_in = x; a.z_in = z; a.d_in = d; a.invd = invd; a.dia = dia;
  a.c1 = c1; a.c2 = c2; a.x = x_out; a.z = z_out;
  // the final direction, in d[n_it % 2], is d_out
  a.d[n_it & 1] = d_out;
  a.d[(n_it + 1) & 1] = d_tmp;
  a.n = n; a.D = D; a.n_it = n_it; a.first = first; a.last = last;
  a.inv_theta = static_cast<T>(inv_theta);
  for (int k = 0; k < D; ++k) a.offs.v[k] = offsets[k];
  void* kargs[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)chunk_kernel<T>, dim3(blocks), dim3(THREADS), kargs, 0,
      static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace cheb
}  // namespace admm

#define ADMM_CHEB_ENTRY(T, SUFFIX)                                            \
  int cheb_dia_chunk_##SUFFIX(                                                \
      const T* b, const T* x, const T* z, const T* d, const T* invd,          \
      const T* dia, const T* c1, const T* c2, T* x_out, T* z_out, T* d_out,   \
      T* d_tmp, const int* offsets, int n, int D, int n_it, int first,        \
      int last, double inv_theta, void* stream) {                             \
    return admm::cheb::launch<T>(b, x, z, d, invd, dia, c1, c2, x_out, z_out, \
                                 d_out, d_tmp, offsets, n, D, n_it, first,    \
                                 last, inv_theta, stream);                    \
  }

extern "C" {

// x_out, z_out, d_out: the chunk's results; d_tmp: (n,3) scratch for the
// other direction buffer; offsets: host array of D ints; inv_theta is cast
// to the working type. Returns the cudaError_t of the launch, or 0.
ADMM_CHEB_ENTRY(float, f32)
ADMM_CHEB_ENTRY(double, f64)

}  // extern "C"
