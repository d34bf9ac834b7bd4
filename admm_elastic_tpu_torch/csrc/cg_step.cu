// One fused Jacobi-PCG vector update, for Hopper: ONE launch on ONE
// thread-block cluster.
//
// Replaces: admm_elastic_tpu/ops/pallas/cg_step.py, cg_update (kernel
// _cg_update_kernel): every vector op of one CG iteration after the
// matvec, in one call:
//   pAp = p.Ap; alpha = rz / pAp (pAp > 0 guard); x' = x + alpha p;
//   r' = r - alpha Ap; z = D^-1 r'; rz' = r'.z; beta = rz' / rz (rz > 0
//   guard); p' = z + beta p
// Vectors are (n,3) row-major (the TPU's (3, n+pad) lane layout is not
// carried over); rz and rz' are one-element device arrays, so nothing is
// read back to the host.
//
// What bounds it on this card: launch latency and the two dependent
// reductions. At delaunay100k (n = 16,280) it moves ~1.4 MB in f32 (0.4 us
// of HBM time, and L2-resident anyway) and does ~0.2 Mflop; one launch
// alone takes longer than that.
//
// Design: the launch shape of the cluster solves (cluster_pcg.cuh): one
// cluster of CLUSTER = 16 CTAs of THREADS = 1,024 threads. CTA `rank`
// owns the slab of rows [rank S, (rank + 1) S), S = ceil(n / 16), which
// its threads walk as t, t + THREADS, ...; a thread loads every input of
// its first row (and rz) at the start and keeps them, then z, in
// registers across both reductions (at delaunay100k, n = 16,280, the
// first row is a thread's only one), and reads any further rows again
// (from L2) in each pass. Each dot is summed as the
// cluster solves sum theirs (push_sum: a thread's rows in turn, each row
// its three products in order; warp trees; every CTA's partial stored into
// every CTA's slot; the 16 partials added in rank order after a cluster
// barrier), so every CTA holds the same alpha and beta, with no atomics
// and no partials in global memory, in cg_step.cluster_dot's order:
//   start   arrive on the cluster barrier (every CTA has started before
//           any writes to another), load, p.Ap over the slab, wait on it
//   1       push the p.Ap partial; cluster barrier; alpha
//   2       x', r', z and r'.z over the slab; push; cluster barrier; beta
//   3       p' = z + beta p over the slab; rank 0 writes rz'
// No CTA touches another's memory after the last barrier, so none waits
// at the end. A thread reads its own rows of an input before it writes
// them, and rz before the last barrier, so each output may be its own
// input's buffer (x_out = x, r_out = r, p_out = p, rz_out = rz).

#include "cluster_pcg.cuh"

namespace admm {
namespace step {

namespace cp = cluster_pcg;
namespace cgr = cooperative_groups;
using cp::CLUSTER;
using cp::THREADS;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T row_dot(const T a[3], const T b[3]) {
  T dot = a[0] * b[0];
  dot = dot + a[1] * b[1];
  return dot + a[2] * b[2];
}

template <typename T>
__device__ __forceinline__ void load3(const T* v, size_t i, T out[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = v[3 * i + c];
}

// x' = x + alpha p, r' = r - alpha Ap of row i (written to x_out, r_out)
// and z = D^-1 r' (d: the row's D^-1); returns r'.z.
template <typename T>
__device__ __forceinline__ T advance(const T x[3], const T r[3],
                                     const T p[3], const T ap[3], T d,
                                     T alpha, size_t i, T* x_out, T* r_out,
                                     T z[3]) {
  T rn[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    x_out[3 * i + c] = x[c] + alpha * p[c];
    rn[c] = r[c] - alpha * ap[c];
    r_out[3 * i + c] = rn[c];
    z[c] = d * rn[c];
  }
  return row_dot(rn, z);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    update_kernel(const T* x, const T* r, const T* p, const T* rz_in,
                  const T* Ap, const T* __restrict__ invd, int n, T* x_out,
                  T* r_out, T* p_out, T* rz_out) {
  __shared__ T slots[2][CLUSTER];  // [0] r'.z, [1] p.Ap, every rank's
  __shared__ T red[cp::WARPS];
  cgr::cluster_group cl = cgr::this_cluster();
  const int me = static_cast<int>(cl.block_rank());
  const int S = (n + CLUSTER - 1) / CLUSTER;
  const int lo = min(me * S, n), hi = min(lo + S, n);
  const int first = lo + static_cast<int>(threadIdx.x);
  const bool own = first < hi;
  auto nothing = [] {};
  cluster_arrive();

  // every input of the first row, and rz, at once: one round trip to L2
  // before the first exchange and none before the second
  T p0[3], a0[3], x0[3], r0[3], d0 = T(0);
  if (own) {
    load3(p, first, p0);
    load3(Ap, first, a0);
    load3(x, first, x0);
    load3(r, first, r0);
    d0 = invd[first];
  }
  const T rz = rz_in[0];
  // p.Ap
  T local = own ? row_dot(p0, a0) : T(0);
  for (int i = first + THREADS; i < hi; i += THREADS) {
    T pv[3], av[3];
    load3(p, i, pv);
    load3(Ap, i, av);
    local = local + row_dot(pv, av);
  }
  cluster_wait();
  cp::push_sum<T, false>(cl, me, local, red, slots[1], nullptr, nothing);
  cl.sync();
  const T pAp = cp::slot_total(slots[1]);
  const T alpha = rz / (pAp > T(0) ? pAp : T(1));

  // x', r', z (the first row's kept in a0) and r'.z
  local = own ? advance(x0, r0, p0, a0, d0, alpha, first, x_out, r_out, a0)
              : T(0);
  for (int i = first + THREADS; i < hi; i += THREADS) {
    T xv[3], rv[3], pv[3], av[3], z[3];
    load3(x, i, xv);
    load3(r, i, rv);
    load3(p, i, pv);
    load3(Ap, i, av);
    local = local + advance(xv, rv, pv, av, invd[i], alpha, i, x_out, r_out,
                            z);
  }
  cp::push_sum<T, false>(cl, me, local, red, slots[0], nullptr, nothing);
  cl.sync();
  const T rz_new = cp::slot_total(slots[0]);
  const T beta = rz_new / (rz > T(0) ? rz : T(1));

  // p' = z + beta p (z again from r' and D^-1 past the first row)
  if (own) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      p_out[3 * static_cast<size_t>(first) + c] = a0[c] + beta * p0[c];
  }
  for (int i = first + THREADS; i < hi; i += THREADS) {
    const size_t g = 3 * static_cast<size_t>(i);
    const T d = invd[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T pi = p[g + c];
      p_out[g + c] = d * r_out[g + c] + beta * pi;
    }
  }
  if (me == 0 && threadIdx.x == 0) rz_out[0] = rz_new;
}

template <typename T>
int update(const T* x, const T* r, const T* p, const T* rz, const T* Ap,
           const T* invd, int n, T* x_out, T* r_out, T* p_out, T* rz_out,
           void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = (const void*)update_kernel<T>;
  cudaError_t e = cp::ready(fn, 0);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        cp::cluster_config(0, static_cast<cudaStream_t>(stream), attr);
    e = cudaLaunchKernelEx(&cfg, update_kernel<T>, x, r, p, rz, Ap, invd, n,
                           x_out, r_out, p_out, rz_out);
  }
  if (e != cudaSuccess) cudaGetLastError();  // returned here, not left behind
  return static_cast<int>(e);
}

}  // namespace step
}  // namespace admm

extern "C" {

// x, r, p, Ap, x_out, r_out, p_out: (n,3); invd: (n,); rz, rz_out: one
// value. Returns the launch's cudaError_t, or 0.
int cg_update_f32(const float* x, const float* r, const float* p,
                  const float* rz, const float* Ap, const float* invd, int n,
                  float* x_out, float* r_out, float* p_out, float* rz_out,
                  void* stream) {
  return admm::step::update<float>(x, r, p, rz, Ap, invd, n, x_out, r_out,
                                   p_out, rz_out, stream);
}

int cg_update_f64(const double* x, const double* r, const double* p,
                  const double* rz, const double* Ap, const double* invd,
                  int n, double* x_out, double* r_out, double* p_out,
                  double* rz_out, void* stream) {
  return admm::step::update<double>(x, r, p, rz, Ap, invd, n, x_out, r_out,
                                    p_out, rz_out, stream);
}

}  // extern "C"
