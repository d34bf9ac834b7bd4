// A chunk of Chebyshev iterations with a sparse-DIAgonal matvec, as ONE
// launch on ONE thread-block cluster, for Hopper.
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
// (dia.cuh Rows, terms past either end are skipped), c1/c2 (n_it,) in
// device memory (the budget varies, so they are not __constant__). The
// Pallas kernel's (3*Lr,128) planes and lane rolls are TPU layout and are
// not carried over.
//
// What bounds it on this card: at the 100k-tet beam (n = 22,386, 19
// diagonals) a pass reads ~2 MB (dia and the vectors), all L2-resident,
// and does ~133 operations per vertex, well under a microsecond of either
// rate; so the synchronisation between passes bounds a call of 179
// iterations (PERF.md).
//
// Design: the cluster solve's (cluster_pcg.cuh) slabs, plan and pushes,
// with no dot products, so no partials. CLUSTER = 16 CTAs of 1,024
// threads; CTA `rank` owns rows [rank S, (rank + 1) S). Only the direction
// d is read across rows (by the matvec); x and z stay row-local. Two
// layouts, chosen by the plan:
//
// WINDOW, when a CTA's window of d, rows [lo - H, hi + H) (clipped to the
// matrix), twice, and its slab's x, z and D^-1 fit in shared memory (8 W
// + 7 S values; tet100k in f32, with its 19 diagonal rows beside them).
// At entry every CTA reads its window of d_in, or with `first` forms z
// and d over its whole window itself from x_in and b (global inputs): no
// push is needed there. Then ONE stage an iteration, no cluster barrier:
//   for each slab row: A d from d over the window; x += d;
//     z -= D^-1 A d; d' = c1 d + c2 z, written to the other d buffer
//   push d' of the slab's edge rows into the windows that hold them (one
//     bulk copy, cp.async.bulk, a receiving CTA, counted on its mbarrier
//     of that buffer) and wait on this CTA's own for the halo rows.
// A row of d is four values (16 bytes in f32), so a run of rows is one
// aligned block. The two buffers alternate, each with its own mbarrier:
// a neighbour can push d' of the next iteration before this CTA has read
// the halo of this one, never of the one after (it waits for this CTA's
// own push first, which comes after that read), so two suffice and no
// phase takes another's bytes. (Pushing z and forming d over the window,
// as the PCG forms p, needs z twice and d once over the window, 11 W +
// 3 S values, which leaves no room for tet100k's diagonals in f32.)
//
// SHARED, when it does not fit (f64 at tet100k, bands reaching past the
// windows): d in global memory, double-buffered (d_out and d_tmp), x and
// z in x_out and z_out, each CTA writing its slab's rows, and one
// cluster.sync() an iteration (never a grid barrier).
//
// Each row keeps the twin's arithmetic (ops/kernels/cheb_dia.py
// cheb_recurrence around dia_apply: diagonals in offset order), built
// without FMA contraction (--fmad=false), so the kernel and the twin agree
// bitwise in both layouts.

#include <algorithm>
#include <climits>
#include <cstdlib>

#include "cluster_pcg.cuh"
#include "dia.cuh"

namespace admm {
namespace cheb {

using cluster_pcg::THREADS;
namespace cgr = cooperative_groups;

// The WINDOW layout's vectors: per window row d twice (four values a
// row), per slab row x, z (3 each) and D^-1 (cluster_pcg::Vectors). No
// global scratch in the SHARED layout: it works in the outputs.
constexpr int PER_WINDOW = 8, PER_SLAB = 7;
constexpr cluster_pcg::Vectors VECTORS = {PER_WINDOW, PER_SLAB, 0};

template <typename T>
struct Args {
  const T* __restrict__ b;
  const T* __restrict__ x_in;
  const T* __restrict__ z_in;
  const T* __restrict__ d_in;
  const T* __restrict__ invd;
  const T* __restrict__ c1;
  const T* __restrict__ c2;
  T* x;     // x_out
  T* z;     // z_out
  T* d[2];  // SHARED: iteration i reads d[i % 2], writes d[(i + 1) % 2]
  int n, H, n_it, first, last;
  T inv_theta;
};

// Row i of A y: the D diagonals at offs (the kernel's argument) in offset
// order, wi[d * ws] the row's value on diagonal d, y's row i + o at yi +
// 3 o; terms outside the matrix skipped (the init and the SHARED pass).
template <typename T>
__device__ __forceinline__ void dia_row(const int* offs, int D, int n,
                                        const T* wi, int ws, int i,
                                        const T* yi, T out[3]) {
  T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const int o = offs[d];
    const int j = i + o;
    if (j >= 0 && j < n) {
      const T wv = wi[d * ws];
      a0 = a0 + wv * yi[3 * o];
      a1 = a1 + wv * yi[3 * o + 1];
      a2 = a2 + wv * yi[3 * o + 2];
    }
  }
  out[0] = a0;
  out[1] = a1;
  out[2] = a2;
}

// Loads of shared memory at a 32-bit shared address, for the WINDOW
// pass. Its addresses come from one base taken at entry: through C++
// pointers the compiler formed the shared window's base again for every
// term (S2UR SR_CgaCtaId in the loop), and a generic load of shared
// memory (a pointer that may be shared or global) cost the pass 22%
// (PERF.md).
__device__ __forceinline__ void lds4(uint32_t a, float v[4]) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(a));
}

__device__ __forceinline__ void lds4(uint32_t a, double v[4]) {
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];"
               : "=d"(v[0]), "=d"(v[1])
               : "r"(a));
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];"
               : "=d"(v[2]), "=d"(v[3])
               : "r"(a + 16));
}

__device__ __forceinline__ float lds(uint32_t a, float) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ double lds(uint32_t a, double) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];" : "=d"(v) : "r"(a));
  return v;
}

// Row i of A d in the WINDOW pass, in dia_row's order: d's row i at the
// shared address di, four values a row (row i + o at di + 4 o
// sizeof(T)); the row's value on diagonal d at the shared address wsh +
// d ws sizeof(T) (MAT) or at wg[d ws].
template <typename T, bool MAT>
__device__ __forceinline__ void window_row(const int* offs, int D, int n,
                                           int i, uint32_t di, uint32_t wsh,
                                           const T* wg, int ws, T out[3]) {
  T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const int o = offs[d];
    const int j = i + o;
    if (j >= 0 && j < n) {
      constexpr int B = sizeof(T);
      const T wv = MAT ? lds(wsh + static_cast<uint32_t>(d * ws * B), T(0))
                       : wg[d * ws];
      T c[4];
      lds4(di + static_cast<uint32_t>(4 * B * o), c);
      a0 = a0 + wv * c[0];
      a1 = a1 + wv * c[1];
      a2 = a2 + wv * c[2];
    }
  }
  out[0] = a0;
  out[1] = a1;
  out[2] = a2;
}

// WINDOW: the vectors in shared memory (else SHARED); MAT: the slab's
// diagonals in shared memory (else read from dia).
template <typename T, bool WINDOW, bool MAT>
__global__ void __launch_bounds__(THREADS, 1)
    chunk_kernel(const dia::Rows<T> row, const Args<T> a, int S, int W) {
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  __shared__ __align__(8) uint64_t bars[2];  // WINDOW: one a d buffer
  cgr::cluster_group cl = cgr::this_cluster();
  const int me = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x;
  const int n = a.n, H = a.H, D = row.D;
  const int lo = min(me * S, n), rows = min(lo + S, n) - lo, hi = lo + rows;
  // WINDOW: rows [wlo, wlo + wn), none for a CTA without rows
  const int wlo = WINDOW && rows ? max(lo - H, 0) : lo;
  const int wn = !WINDOW ? rows : rows ? min(hi + H, n) - wlo : 0;
  const int off = lo - wlo;  // a slab row's place in the window
  T* dyn = reinterpret_cast<T*>(dyn_raw);
  // the same as 32-bit shared addresses, for the WINDOW pass
  const uint32_t dyn_sh = cluster_pcg::smem_addr(dyn_raw);
  const uint32_t dbuf_bytes = 4 * W * sizeof(T);
  if (WINDOW && tid == 0) {
    for (int q = 0; q < 2; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       cluster_pcg::smem_addr(&bars[q]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the slab's diagonals: row lo + li's value on diagonal d at wm[d * ws +
  // li]
  T* wsm = dyn + (WINDOW ? cluster_pcg::region(W, S, PER_WINDOW, PER_SLAB)
                         : 0);
  const T* wm = MAT ? wsm : row.dia + lo;
  const uint32_t wm_sh = cluster_pcg::smem_addr(wsm);
  const int ws = MAT ? rows : n;
  if (MAT) {
    for (int q = tid; q < D * rows; q += THREADS) {
      const int d = q / rows, li = q - d * rows;
      wsm[q] = row.dia[static_cast<size_t>(d) * n + lo + li];
    }
  }
  const int* offs = row.offs.v;
  // WINDOW: d over the window twice (d_k in buffer k % 2), then the
  // slab's x, z, D^-1
  T* xs = dyn + 8 * W;
  T* zs = xs + 3 * S;
  T* is = zs + 3 * S;

  // d_0 over the window (WINDOW) or the slab (SHARED); x, z, D^-1 of the
  // slab
  for (int q = tid; q < wn; q += THREADS) {
    const int i = wlo + q, li = i - lo;
    const bool mine = li >= 0 && li < rows;
    const T id = a.invd[i];
    T zc[3], dc[3];
    if (a.first) {
      T ax[3];
      dia_row<T>(offs, D, n, row.dia + i, n, i, a.x_in + 3 * i, ax);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        zc[c] = id * (a.b[3 * static_cast<size_t>(i) + c] - ax[c]);
        dc[c] = a.inv_theta * zc[c];
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        zc[c] = a.z_in[3 * static_cast<size_t>(i) + c];
        dc[c] = a.d_in[3 * static_cast<size_t>(i) + c];
      }
    }
    if (WINDOW) {
      const T d4[4] = {dc[0], dc[1], dc[2], T(0)};
      cluster_pcg::st4(dyn + 4 * q, d4);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const size_t g = 3 * static_cast<size_t>(i) + c;
      if (!WINDOW) {
        a.d[0][g] = dc[c];
        a.z[g] = zc[c];
        a.x[g] = a.x_in[g];
      } else if (mine) {
        zs[3 * li + c] = zc[c];
        xs[3 * li + c] = a.x_in[g];
      }
    }
    if (WINDOW && mine) is[li] = id;
  }
  // WINDOW: every CTA has started (its mbarriers are set up) before any
  // writes to another; SHARED: every slab's d_0 is written before any CTA
  // reads it
  cl.sync();

  // WINDOW: the slab's rows of d' that other CTAs' windows hold go into
  // those windows, one bulk copy a window, by warp 1 once the CTA's rows
  // are written.
  const int t_first = rows ? max(lo - H, 0) / S : 0;
  const int t_last = rows ? min(hi - 1 + H, n - 1) / S : -1;
  const uint32_t halo = 4 * sizeof(T) * (wn - rows);
  for (int k = 0; k < a.n_it; ++k) {
    const T c1 = a.c1[k], c2 = a.c2[k];
    if (WINDOW) {
      T* dnxt = dyn + (k & 1 ? 0 : 4 * W);
      const uint32_t dcur_sh = dyn_sh + (k & 1 ? dbuf_bytes : 0);
      for (int li = tid; li < rows; li += THREADS) {
        T ad[3], dc[4];
        const uint32_t di = dcur_sh + (off + li) * 4 * sizeof(T);
        window_row<T, MAT>(offs, D, n, lo + li, di,
                           wm_sh + li * sizeof(T), wm + li, ws, ad);
        lds4(di, dc);
        const T id = is[li];
        T dn[4];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          xs[3 * li + c] = xs[3 * li + c] + dc[c];
          const T zc = zs[3 * li + c] - id * ad[c];
          zs[3 * li + c] = zc;
          dn[c] = c1 * dc[c] + c2 * zc;
        }
        dn[3] = T(0);
        cluster_pcg::st4(dnxt + 4 * (off + li), dn);
      }
      cluster_pcg::fence_async();
      __syncthreads();
      // d' of iteration k is buffer (k + 1) % 2's (k / 2)-th phase
      uint64_t* bar = &bars[(k + 1) & 1];
      if (tid == 0) cluster_pcg::mbar_expect(bar, halo);
      if ((tid >> 5) == 1) {
        for (int t = t_first + (tid & 31); t <= t_last; t += 32) {
          const int tlo = max(t * S - H, 0);
          const int b0 = max(lo, tlo), e = min(hi, min(t * S + S + H, n));
          if (t != me && b0 < e)
            cluster_pcg::bulk_push(dnxt + 4 * (b0 - tlo),
                                   dnxt + 4 * (b0 - wlo),
                                   4 * sizeof(T) * (e - b0), bar, t);
        }
      }
      cluster_pcg::mbar_wait(bar, (k >> 1) & 1);
    } else {
      const T* dcur = k & 1 ? a.d[1] : a.d[0];
      T* dnxt = k & 1 ? a.d[0] : a.d[1];
      for (int li = tid; li < rows; li += THREADS) {
        const int i = lo + li;
        T ad[3];
        dia_row<T>(offs, D, n, wm + li, ws, i, dcur + 3 * i, ad);
        const T id = a.invd[i];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const size_t g = 3 * static_cast<size_t>(i) + c;
          const T dc = dcur[g];
          a.x[g] = a.x[g] + dc;
          const T zc = a.z[g] - id * ad[c];
          a.z[g] = zc;
          dnxt[g] = c1 * dc + c2 * zc;
        }
      }
      cl.sync();
    }
  }

  // the final direction, d_{n_it}, goes to d_out (a.d[n_it % 2])
  T* dout = a.n_it & 1 ? a.d[1] : a.d[0];
  const T* dfin = WINDOW ? dyn + (a.n_it & 1 ? 4 * W : 0) : dout;
  for (int li = tid; li < rows; li += THREADS) {
    const int i = lo + li;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const size_t g = 3 * static_cast<size_t>(i) + c;
      if (WINDOW) {
        const T dc = dfin[4 * (off + li) + c];
        a.x[g] = a.last ? xs[3 * li + c] + dc : xs[3 * li + c];
        a.z[g] = zs[3 * li + c];
        dout[g] = dc;
      } else if (a.last) {
        a.x[g] = a.x[g] + dfin[g];
      }
    }
  }
  cl.sync();  // no CTA exits while another may still read from it
}

// The set-up of chunk_kernel<T, WINDOW, MAT> (cluster_pcg::ready), then
// its launch.
template <typename T, bool WINDOW, bool MAT>
cudaError_t launch_kernel(const cudaLaunchConfig_t& cfg,
                          const dia::Rows<T>& row, const Args<T>& a,
                          const cluster_pcg::Plan& pl) {
  const cudaError_t e = cluster_pcg::ready(
      (const void*)chunk_kernel<T, WINDOW, MAT>, pl.smem_bytes);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, chunk_kernel<T, WINDOW, MAT>, row, a,
                            pl.slab, pl.window);
}

template <typename T>
int launch(const T* b, const T* x, const T* z, const T* d, const T* invd,
           const T* dia_vals, const T* c1, const T* c2, T* x_out, T* z_out,
           T* d_out, T* d_tmp, const int* offsets, int n, int D, int n_it,
           int first, int last, double inv_theta, void* stream) {
  // the kernel's offsets into the vectors and the diagonals are 32-bit
  if (n < 1 || D < 1 || D > dia::MAX_DIAGONALS || n_it < 0 ||
      static_cast<long long>(D) * n > INT_MAX / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  dia::Rows<T> row{dia_vals, {}, D, n};
  int H = 0;
  for (int k = 0; k < D; ++k) {
    row.offs.v[k] = offsets[k];
    H = std::max(H, std::abs(offsets[k]));
  }
  cluster_pcg::Plan pl;
  int err = cluster_pcg::plan_for_device(n, H, D, sizeof(T), &pl, VECTORS);
  if (err != 0) return err;
  Args<T> a{};
  a.b = b; a.x_in = x; a.z_in = z; a.d_in = d; a.invd = invd;
  a.c1 = c1; a.c2 = c2; a.x = x_out; a.z = z_out;
  // the final direction, in d[n_it % 2], is d_out
  a.d[n_it & 1] = d_out;
  a.d[(n_it + 1) & 1] = d_tmp;
  a.n = n; a.H = H; a.n_it = n_it; a.first = first; a.last = last;
  a.inv_theta = static_cast<T>(inv_theta);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_pcg::cluster_config(
      pl.smem_bytes, static_cast<cudaStream_t>(stream), attr);
  cudaError_t e;
  if (pl.vec_smem)
    e = pl.mat_smem ? launch_kernel<T, true, true>(cfg, row, a, pl)
                    : launch_kernel<T, true, false>(cfg, row, a, pl);
  else
    e = pl.mat_smem ? launch_kernel<T, false, true>(cfg, row, a, pl)
                    : launch_kernel<T, false, false>(cfg, row, a, pl);
  if (e != cudaSuccess) cudaGetLastError();  // returned here, not left behind
  return static_cast<int>(e);
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
// to the working type. Returns the first nonzero cudaError_t of the
// set-up (cudaErrorInvalidClusterSize if the card cannot place the
// cluster) and the launch, or 0.
ADMM_CHEB_ENTRY(float, f32)
ADMM_CHEB_ENTRY(double, f64)

// The layout of a chunk of n rows, D diagonals reaching H rows, elements
// of elem_bytes on the current device: out = slab rows, window rows,
// vectors in shared memory (0/1), diagonals in shared memory (0/1),
// dynamic shared memory a CTA in bytes. Returns a cudaError_t.
int cheb_dia_plan(int n, int H, int D, int elem_bytes, long long* out) {
  admm::cluster_pcg::Plan p;
  const int err = admm::cluster_pcg::plan_for_device(
      n, H, D, elem_bytes, &p, admm::cheb::VECTORS);
  if (err != 0) return err;
  out[0] = p.slab;
  out[1] = p.window;
  out[2] = p.vec_smem;
  out[3] = p.mat_smem;
  out[4] = p.smem_bytes;
  return 0;
}

}  // extern "C"
