// The multigrid modes of the cluster solve: fixed-budget PCG whose
// preconditioner is a two-coarse-level V-cycle, as ONE launch on ONE
// thread-block cluster. Two hierarchies share the kernel, as a policy
// (Levels) beside the fine rows (Row):
//   GridLevels, the geometric multigrid of a grid mesh in nested
//     numbering (core/mg.py): every level indexed by fine row, the
//     level-1 operator as masked diagonals, the transfers as corner masks;
//   AggLevels, the algebraic multigrid of a mesh of any topology
//     (core/uamg.py): aggregates, each level's dofs contiguous, A1 as ELL
//     rows, R a sum over each aggregate's members in ascending order, P a
//     gather at each dof's aggregate.
//
// Replaces: the multigrid mode (mg_meta) of the whole-timestep Pallas
// kernels, admm_elastic_tpu/ops/pallas/banded_step.py:600-739 (the cycle)
// and :924-951 (the PCG around it), and cloth_step.py:457-595 and
// :627-673, whose coarsest product is the kernel's own jnp.dot
// (banded_step.py:689-702): here too it is this kernel's own loop; and
// the algebraic mode (uamg_meta) of banded_step.py, :741-888 and :924-955,
// whose transfer ops, uell slots and (128,128) blocks of A2^-1 are TPU
// layout (AggLevels). The host builds the levels (core/mg.py,
// core/uamg.py); ops/kernels/mg.py and ops/kernels/uamg.py are the plain
// twins, op for op and sum for sum.
//
// Per PCG iteration, z = V(r) for the three columns of the (n,3) vectors
// in place of z = D^-1 r:
//   A  t  = r - A (om0 r)                    (z = om0 r is recomputed)
//   B  r1 = R0 t;  z1 = om1 r1               grid: R0 = sum_c M0_c .
//                                            shift(+c); agg: member sums
//   C  t1 = r1 - A1 z1                       A1: masked level-1 diagonals
//                                            (grid) or ELL rows (agg)
//   D  r2 = R1 t1, every CTA all of it, in shared memory; then z2 = A2^-1
//      r2 (grid: at rp2), rows k split over the 16 CTAs, one warp a row:
//      lane l adds j = l, l + 32, ... in turn, then a halving tree over
//      the lanes
//   E  z1 = z1 + P1 z2                       grid: P1 = sum_c shift(M1_c
//                                            . , -c); agg: z2 at c1
//   F  z1' = z1 + om1 (r1 - A1 z1)
//   G  zz = om0 r + P0 z1'
//   H  z = zz + om0 (r - A zz); r.z
// then p = z + beta p, with JAX's rz > 0 and pAp > 0 guards. Terms past
// either end of the matrix give 0, as the twin's shifts do. The grid's
// level-1 stages (B, C, E, F) run over the fine slab; the aggregates' over
// a slab of the nc1 level-1 dofs.
//
// Layout. The levels reach far: at tet100k (strides 546, 21, 1) the fine
// band reaches 568 rows but A1 and the level-1 corners 1,136, and at
// cloth100k (ladder (2, 8), strides 226, 1) the corners reach 6 * 227 =
// 1,362 rows, so the WINDOW layout's halo of H rows does not cover them;
// an aggregate's members and A1's rows reach across the whole numbering.
// Every vector lives in global scratch (the SHARED layout's way with p),
// (n,3) each, each CTA writing its slab's rows; a stage that reads another
// slab's rows of a vector begins after a cluster.sync() (barrier.cluster
// arrive.release / wait.acquire, never a grid barrier). An iteration is
// 11 such stages: A p and p.Ap; the x and r update; A to H (the dot's
// partials, as the Jacobi solve's, pushed as plain remote stores); p. It
// is a kernel of its own rather than a mode of cluster_pcg.cuh's solve:
// with every vector in global scratch and stages of its own, it shares
// with that template only the dot's exchange (push_sum, slot_total) and
// the cluster's launch, which it takes from there; a mode would make the
// Jacobi template branch on its caller in every stage.
// The slab's fine diagonals sit in shared memory where they fit beside
// the coarsest residual (nc2 x 3 values), a choice made at run time: made
// at compile time (as cheb_dia.cu does) it was 1-2% slower on the H100,
// where this kernel's time is its barriers and L2 reads; a CTA barrier
// follows their staging
// (read before it, they raced with the previous launch's leftovers: the
// route broke now and then). ELL fine rows stream from L2 (cg_ell.cu).
// The iterations are one loop whose first pass
// (k = -1) is the start's V-cycle, with no lambda holding the vectors: a
// lambda captured them by reference onto the stack, 128 bytes a thread
// in f32, and cost 7%. A simple kernel first: its speed (11 barriers an
// iteration, the grid's level-1 stages computed over every fine row, 0
// off the level's representatives) is later work.
//
// What bounds it on this card: latency. An iteration at tet100k reads
// ~4 MB (the diagonals at both levels, the masks, A2^-1 at 462^2 in f32,
// 0.85 MB, the vectors), all L2-resident, and does ~3 Mflop: a
// microsecond of either rate, behind 11 cluster barriers. At cloth100k
// A2^-1 is 841^2 (2.8 MB in f32, 5.7 MB in f64), read from L2. At
// delaunay100k (aggregates 16,280 -> 3,696 -> 501) the fine ELL rows are
// 4.2 MB in f32, A1's 32 slots 0.9 MB and A2^-1 1.0 MB, also from L2.
//
// Sums: the matvecs add their diagonals in offset order (ELL rows their
// slots in order), the transfers their corners (members) in order, the
// dots as the Jacobi solve (cluster_pcg.cuh), the coarsest rows as above;
// no atomics, so two runs are bitwise equal and the kernel equals its twin
// bitwise (--fmad=false).
#pragma once

#include "cluster_pcg.cuh"
#include "dia.cuh"

namespace admm {
namespace mg {

namespace cgr = cooperative_groups;
using cluster_pcg::CLUSTER;
using cluster_pcg::FULL;
using cluster_pcg::THREADS;
using cluster_pcg::WARPS;

constexpr int MAX_CORNERS = 64;  // a transfer's corners (ratio 4 in 3D)
constexpr int LANES = 32;        // lanes of one coarsest-level row

template <typename T>
__device__ __forceinline__ void ld3(const T* v, int j, T c[3]) {
  const T* q = v + 3 * static_cast<size_t>(j);
  c[0] = q[0];
  c[1] = q[1];
  c[2] = q[2];
}

template <typename T>
__device__ __forceinline__ void st3(T* v, int i, const T c[3]) {
  T* q = v + 3 * static_cast<size_t>(i);
  q[0] = c[0];
  q[1] = c[1];
  q[2] = c[2];
}

// out = row i of sum_c M_c . shift(x, +c), the corners in order.
template <typename T>
__device__ __forceinline__ void restrict_row(const T* __restrict__ masks,
                                             const int* offs, int C,
                                             const T* x, int n, int i,
                                             T out[3]) {
  for (int ci = 0; ci < C; ++ci) {
    const int j = i + offs[ci];
    const T m = masks[static_cast<size_t>(ci) * n + i];
    T v[3] = {T(0), T(0), T(0)};
    if (j >= 0 && j < n) ld3(x, j, v);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T y = m * v[k];
      out[k] = ci == 0 ? y : out[k] + y;
    }
  }
}

// out = row i of sum_c shift(M_c . x, -c), the corners in order.
template <typename T>
__device__ __forceinline__ void prolong_row(const T* __restrict__ masks,
                                            const int* offs, int C,
                                            const T* x, int n, int i,
                                            T out[3]) {
  for (int ci = 0; ci < C; ++ci) {
    const int j = i - offs[ci];
    T y[3] = {T(0), T(0), T(0)};
    if (j >= 0 && j < n) {
      const T m = masks[static_cast<size_t>(ci) * n + j];
      T v[3];
      ld3(x, j, v);
#pragma unroll
      for (int k = 0; k < 3; ++k) y[k] = m * v[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] = ci == 0 ? y[k] : out[k] + y[k];
  }
}

// What the C entries take of a geometric multigrid (ops/kernels/mg.py
// MGHost): the planes (D1,n), (n,), (n,), (C0,n), (C1,n), (nc2,) int,
// (nc2,nc2), in the solve's type, then the sizes and the offset tables
// (fine flat-index units).
struct Host {
  const void* l1;
  const void* om0;
  const void* om1;
  const void* t0;
  const void* t1;
  const int* rp2;
  const void* a2inv;
  int D1, C0, C1, nc2;
  int l1_offs[dia::MAX_DIAGONALS];
  int t0_offs[MAX_CORNERS];
  int t1_offs[MAX_CORNERS];
};

// The geometric levels: every level's vectors indexed by fine row, the
// coarse levels 0 off their representatives.
template <typename T>
struct GridLevels {
  static constexpr bool FINE_SLAB = true;  // level 1 over the fine rows
  const T* __restrict__ l1;
  const T* __restrict__ om0;
  const T* __restrict__ om1;
  const T* __restrict__ t0;
  const T* __restrict__ t1;
  const int* __restrict__ rp2;
  const T* __restrict__ a2inv;
  int D1, C0, C1, nc2;
  int l1_offs[dia::MAX_DIAGONALS];
  int t0_offs[MAX_CORNERS];
  int t1_offs[MAX_CORNERS];

  static int of(const void* host, GridLevels* out) {
    const Host* h = static_cast<const Host*>(host);
    if (h == nullptr || h->D1 < 1 || h->D1 > dia::MAX_DIAGONALS ||
        h->C0 < 1 || h->C0 > MAX_CORNERS || h->C1 < 1 ||
        h->C1 > MAX_CORNERS || h->nc2 < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    GridLevels p{};
    p.l1 = static_cast<const T*>(h->l1);
    p.om0 = static_cast<const T*>(h->om0);
    p.om1 = static_cast<const T*>(h->om1);
    p.t0 = static_cast<const T*>(h->t0);
    p.t1 = static_cast<const T*>(h->t1);
    p.rp2 = h->rp2;
    p.a2inv = static_cast<const T*>(h->a2inv);
    p.D1 = h->D1;
    p.C0 = h->C0;
    p.C1 = h->C1;
    p.nc2 = h->nc2;
    for (int d = 0; d < h->D1; ++d) p.l1_offs[d] = h->l1_offs[d];
    for (int c = 0; c < h->C0; ++c) p.t0_offs[c] = h->t0_offs[c];
    for (int c = 0; c < h->C1; ++c) p.t1_offs[c] = h->t1_offs[c];
    *out = p;
    return 0;
  }

  __device__ __forceinline__ int n1(int n) const { return n; }

  // out = row i of A1 y (core.solver.dia_apply's order)
  __device__ __forceinline__ void l1_row(int n, int i, const T* y,
                                         T out[3]) const {
    T a0 = T(0), a1 = T(0), a2 = T(0);
    for (int d = 0; d < D1; ++d) {
      const int j = i + l1_offs[d];
      if (j >= 0 && j < n) {
        const T w = l1[static_cast<size_t>(d) * n + i];
        T c[3];
        ld3(y, j, c);
        a0 = a0 + w * c[0];
        a1 = a1 + w * c[1];
        a2 = a2 + w * c[2];
      }
    }
    out[0] = a0;
    out[1] = a1;
    out[2] = a2;
  }
  __device__ __forceinline__ void restrict0(const T* x, int n, int i,
                                            T out[3]) const {
    restrict_row(t0, t0_offs, C0, x, n, i, out);
  }
  // the k-th coarsest residual, and the row of z2 its solution goes to
  __device__ __forceinline__ void restrict1(const T* x, int n, int k,
                                            T out[3]) const {
    restrict_row(t1, t1_offs, C1, x, n, rp2[k], out);
  }
  __device__ __forceinline__ int z2_row(int k) const { return rp2[k]; }
  __device__ __forceinline__ void prolong1(const T* z2, int n, int i,
                                           T out[3]) const {
    prolong_row(t1, t1_offs, C1, z2, n, i, out);
  }
  __device__ __forceinline__ void prolong0(const T* z1, int n, int i,
                                           T out[3]) const {
    prolong_row(t0, t0_offs, C0, z1, n, i, out);
  }
};

// What the C entries take of an algebraic multigrid (ops/kernels/uamg.py
// UAMGHost): c0 (n,) int, m1 (M1,nc1) int, l1_idx (K1,nc1) int, l1_vals
// (K1,nc1), om0 (n,), om1 (nc1,), c1 (nc1,) int, m2 (M2,nc2) int, a2inv
// (nc2,nc2), floats in the solve's type, then the sizes. Member lists are
// slot-major, each aggregate's members ascending, then the level's size
// (the sentinel: adds 0); A1's empty slots hold value 0.
struct AggHost {
  const int* c0;
  const int* m1;
  const int* l1_idx;
  const void* l1_vals;
  const void* om0;
  const void* om1;
  const int* c1;
  const int* m2;
  const void* a2inv;
  int nc1, M1, K1, nc2, M2;
};

// The algebraic levels: level-1 and level-2 dofs numbered 0.., R a sum
// over each aggregate's members in ascending order, P a gather.
template <typename T>
struct AggLevels {
  static constexpr bool FINE_SLAB = false;  // level 1 over its own slab
  const int* __restrict__ c0;
  const int* __restrict__ m1;
  const int* __restrict__ l1_idx;
  const T* __restrict__ l1_vals;
  const T* __restrict__ om0;
  const T* __restrict__ om1;
  const int* __restrict__ c1;
  const int* __restrict__ m2;
  const T* __restrict__ a2inv;
  int nc1, M1, K1, nc2, M2;

  static int of(const void* host, AggLevels* out) {
    const AggHost* h = static_cast<const AggHost*>(host);
    if (h == nullptr || h->nc1 < 1 || h->M1 < 1 || h->K1 < 1 ||
        h->nc2 < 1 || h->M2 < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    AggLevels p{};
    p.c0 = h->c0;
    p.m1 = h->m1;
    p.l1_idx = h->l1_idx;
    p.l1_vals = static_cast<const T*>(h->l1_vals);
    p.om0 = static_cast<const T*>(h->om0);
    p.om1 = static_cast<const T*>(h->om1);
    p.c1 = h->c1;
    p.m2 = h->m2;
    p.a2inv = static_cast<const T*>(h->a2inv);
    p.nc1 = h->nc1;
    p.M1 = h->M1;
    p.K1 = h->K1;
    p.nc2 = h->nc2;
    p.M2 = h->M2;
    *out = p;
    return 0;
  }

  // out = the sum of x over the members of dof i (m: M slots of nc), in
  // order; a sentinel (>= N) adds 0
  static __device__ __forceinline__ void member_sum(
      const int* __restrict__ m, int M, int nc, int N, const T* x, int i,
      T out[3]) {
    for (int k = 0; k < M; ++k) {
      const int j = m[static_cast<size_t>(k) * nc + i];
      T v[3] = {T(0), T(0), T(0)};
      if (j < N) ld3(x, j, v);
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c] = k == 0 ? v[c] : out[c] + v[c];
    }
  }

  __device__ __forceinline__ int n1(int) const { return nc1; }

  // out = row i of A1 y, the slots in order
  __device__ __forceinline__ void l1_row(int, int i, const T* y,
                                         T out[3]) const {
    T a0 = T(0), a1 = T(0), a2 = T(0);
    for (int k = 0; k < K1; ++k) {
      const size_t q = static_cast<size_t>(k) * nc1 + i;
      const T w = l1_vals[q];
      T c[3];
      ld3(y, l1_idx[q], c);
      a0 = a0 + w * c[0];
      a1 = a1 + w * c[1];
      a2 = a2 + w * c[2];
    }
    out[0] = a0;
    out[1] = a1;
    out[2] = a2;
  }
  __device__ __forceinline__ void restrict0(const T* x, int n, int i,
                                            T out[3]) const {
    member_sum(m1, M1, nc1, n, x, i, out);
  }
  __device__ __forceinline__ void restrict1(const T* x, int, int k,
                                            T out[3]) const {
    member_sum(m2, M2, nc2, nc1, x, k, out);
  }
  __device__ __forceinline__ int z2_row(int k) const { return k; }
  __device__ __forceinline__ void prolong1(const T* z2, int, int i,
                                           T out[3]) const {
    ld3(z2, c1[i], out);
  }
  __device__ __forceinline__ void prolong0(const T* z1, int, int i,
                                           T out[3]) const {
    ld3(z1, c0[i], out);
  }
};

// The solve's vectors in global scratch, (n,3) each (the algebraic
// levels' use their first nc1 or nc2 rows).
enum Vector { R, P, X, AP, Z, TT, R1, Z1, Z1B, T1, Z2, ZZ, N_VECTORS };

// Shared memory before the slab's diagonals: the coarsest residual, in
// elements of T, rounded up to 4 values.
__host__ __device__ inline long long r2_region(int nc2) {
  return (3LL * nc2 + 3) / 4 * 4;
}

struct Plan {
  int slab;           // S: rows a CTA owns
  int mat_smem;       // 1: the slab's fine diagonals are in shared memory
  int smem_bytes;     // dynamic shared memory a CTA
  long long scratch;  // elements of global scratch
};

// D: the fine rows' matrix values a row staged in shared memory (dia:
// the diagonals; ELL rows: 0, they stream from L2).
inline int plan_for_device(int n, int D, int nc2, int elem, Plan* out) {
  if (n < 1 || D < 0 || nc2 < 1 || (elem != 4 && elem != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  limit -= cluster_pcg::STATIC_SMEM;
  Plan p;
  p.slab = (n + CLUSTER - 1) / CLUSTER;
  const long long r2 = r2_region(nc2) * elem;
  const long long mat = static_cast<long long>(D) * p.slab * elem;
  if (r2 > limit) return static_cast<int>(cudaErrorInvalidValue);
  p.mat_smem = r2 + mat <= limit;
  p.smem_bytes = static_cast<int>(r2 + (p.mat_smem ? mat : 0));
  p.scratch = static_cast<long long>(N_VECTORS) * 3 * n;
  *out = p;
  return 0;
}

// Solves A X = B, (n,3) row-major, by `iters` V-cycle PCG iterations from
// x0; x_out may be x0 (x0 is read before the first stage end only, x_out
// written after the last). g: N_VECTORS * 3n elements of scratch.
template <typename T, typename Levels, typename Row>
__global__ void __launch_bounds__(THREADS, 1)
    solve_kernel(const __grid_constant__ Row row,
                 const __grid_constant__ Levels mg,
                 const T* __restrict__ b, const T* x0, int n, int iters,
                 T* x_out, T* g, int S, int mat_smem) {
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  // every rank's partials: [0] r.z, [1] p.Ap
  __shared__ T slots[2][CLUSTER];
  __shared__ T red[WARPS];
  cgr::cluster_group cl = cgr::this_cluster();
  const int me = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = min(me * S, n), rows = min(lo + S, n) - lo;
  // the level-1 stages' rows: the fine slab, or a slab of the nc1 dofs
  int lo1 = lo, rows1 = rows;
  if constexpr (!Levels::FINE_SLAB) {
    const int n1 = mg.n1(n), S1 = (n1 + CLUSTER - 1) / CLUSTER;
    lo1 = min(me * S1, n1);
    rows1 = min(lo1 + S1, n1) - lo1;
  }
  T* r2s = reinterpret_cast<T*>(dyn_raw);
  const typename Row::View mv =
      row.stage(lo, rows, mat_smem ? r2s + r2_region(mg.nc2) : nullptr);
  const size_t gn = 3 * static_cast<size_t>(n);
  T* const r = g + R * gn;
  T* const p = g + P * gn;
  T* const xs = g + X * gn;
  T* const aps = g + AP * gn;
  T* const z = g + Z * gn;
  T* const tt = g + TT * gn;
  T* const r1 = g + R1 * gn;
  T* const z1 = g + Z1 * gn;
  T* const z1b = g + Z1B * gn;
  T* const t1 = g + T1 * gn;
  T* const z2 = g + Z2 * gn;
  T* const zz = g + ZZ * gn;
  auto nothing = [] {};
  const T zero[3] = {T(0), T(0), T(0)};
  for (int li = tid; li < rows; li += THREADS) st3(z2, lo + li, zero);
  __syncthreads();  // the staged matrix rows and offsets are in place

  // r = b - A x0; x = x0
  for (int li = tid; li < rows; li += THREADS) {
    const int i = lo + li;
    T ax[3], q[3];
    row(mv, i, li, [&](int j, T c[3]) { ld3(x0, j, c); }, ax);
    ld3(x0, i, q);
    st3(xs, i, q);
#pragma unroll
    for (int c = 0; c < 3; ++c) q[c] = b[3 * static_cast<size_t>(i) + c] - ax[c];
    st3(r, i, q);
  }
  cl.sync();  // every CTA has started; r and z2 are written

  // k = -1: z = V(r0), p = z; then the iterations
  T rz = T(0);
  for (int k = -1; k < iters; ++k) {
    if (k >= 0) {
      // A p and p.Ap over the slab
      T local = T(0);
      for (int li = tid; li < rows; li += THREADS) {
        const int i = lo + li;
        T ap[3], q[3];
        row(mv, i, li, [&](int j, T c[3]) { ld3(p, j, c); }, ap);
        st3(aps, i, ap);
        ld3(p, i, q);
        T dot = T(0);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          dot = c == 0 ? q[c] * ap[c] : dot + q[c] * ap[c];
        local = local + dot;
      }
      cluster_pcg::push_sum<T, false>(cl, me, local, red, slots[1], nullptr,
                                      nothing);
      cl.sync();
      const T pAp = cluster_pcg::slot_total(slots[1]);
      const T alpha = rz / (pAp > T(0) ? pAp : T(1));
      // x += alpha p; r -= alpha Ap
      for (int li = tid; li < rows; li += THREADS) {
        const int i = lo + li;
        T q[3], x3[3], r3[3], a3[3];
        ld3(p, i, q);
        ld3(xs, i, x3);
        ld3(r, i, r3);
        ld3(aps, i, a3);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          x3[c] = x3[c] + alpha * q[c];
          r3[c] = r3[c] - alpha * a3[c];
        }
        st3(xs, i, x3);
        st3(r, i, r3);
      }
      cl.sync();
    }
    // z = V(r): A. t = r - A (om0 r)
    for (int li = tid; li < rows; li += THREADS) {
      const int i = lo + li;
      T az[3], q[3];
      row(mv, i, li,
          [&](int j, T c[3]) {
            const T o = mg.om0[j];
            ld3(r, j, c);
            c[0] = o * c[0];
            c[1] = o * c[1];
            c[2] = o * c[2];
          },
          az);
      ld3(r, i, q);
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c] = q[c] - az[c];
      st3(tt, i, q);
    }
    cl.sync();
    // B. r1 = R0 t; z1 = om1 r1
    for (int li = tid; li < rows1; li += THREADS) {
      const int i = lo1 + li;
      T q[3];
      mg.restrict0(tt, n, i, q);
      st3(r1, i, q);
      const T o = mg.om1[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c] = o * q[c];
      st3(z1, i, q);
    }
    cl.sync();
    // C. t1 = r1 - A1 z1
    for (int li = tid; li < rows1; li += THREADS) {
      const int i = lo1 + li;
      T az[3], q[3];
      mg.l1_row(n, i, z1, az);
      ld3(r1, i, q);
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c] = q[c] - az[c];
      st3(t1, i, q);
    }
    cl.sync();
    // D. r2 = R1 t1 into shared memory; z2 = A2^-1 r2
    for (int q2 = tid; q2 < mg.nc2; q2 += THREADS) {
      T q[3];
      mg.restrict1(t1, n, q2, q);
      r2s[3 * q2] = q[0];
      r2s[3 * q2 + 1] = q[1];
      r2s[3 * q2 + 2] = q[2];
    }
    __syncthreads();
    {
      const int S2 = (mg.nc2 + CLUSTER - 1) / CLUSTER;
      const int k0 = min(me * S2, mg.nc2), k1 = min(k0 + S2, mg.nc2);
      for (int kr = k0 + warp; kr < k1; kr += WARPS) {
        const T* ak = mg.a2inv + static_cast<size_t>(kr) * mg.nc2;
        T a0 = T(0), a1 = T(0), a2 = T(0);
        for (int j = lane; j < mg.nc2; j += LANES) {
          const T w = ak[j];
          a0 = a0 + w * r2s[3 * j];
          a1 = a1 + w * r2s[3 * j + 1];
          a2 = a2 + w * r2s[3 * j + 2];
        }
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1) {
          a0 = a0 + __shfl_down_sync(FULL, a0, off);
          a1 = a1 + __shfl_down_sync(FULL, a1, off);
          a2 = a2 + __shfl_down_sync(FULL, a2, off);
        }
        if (lane == 0) {
          const T q[3] = {a0, a1, a2};
          st3(z2, mg.z2_row(kr), q);
        }
      }
    }
    cl.sync();
    // E. z1 = z1 + P1 z2
    for (int li = tid; li < rows1; li += THREADS) {
      const int i = lo1 + li;
      T pz[3], q[3];
      mg.prolong1(z2, n, i, pz);
      ld3(z1, i, q);
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c] = q[c] + pz[c];
      st3(z1, i, q);
    }
    cl.sync();
    // F. z1' = z1 + om1 (r1 - A1 z1)
    for (int li = tid; li < rows1; li += THREADS) {
      const int i = lo1 + li;
      T az[3], q[3], s3[3];
      mg.l1_row(n, i, z1, az);
      ld3(r1, i, s3);
      ld3(z1, i, q);
      const T o = mg.om1[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c] = q[c] + o * (s3[c] - az[c]);
      st3(z1b, i, q);
    }
    cl.sync();
    // G. zz = om0 r + P0 z1'
    for (int li = tid; li < rows; li += THREADS) {
      const int i = lo + li;
      T pz[3], q[3];
      mg.prolong0(z1b, n, i, pz);
      ld3(r, i, q);
      const T o = mg.om0[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c] = o * q[c] + pz[c];
      st3(zz, i, q);
    }
    cl.sync();
    // H. z = zz + om0 (r - A zz); r.z
    T local = T(0);
    for (int li = tid; li < rows; li += THREADS) {
      const int i = lo + li;
      T az[3], q[3], s3[3];
      row(mv, i, li, [&](int j, T c[3]) { ld3(zz, j, c); }, az);
      ld3(r, i, s3);
      ld3(zz, i, q);
      const T o = mg.om0[i];
      T dot = T(0);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q[c] = q[c] + o * (s3[c] - az[c]);
        dot = c == 0 ? s3[c] * q[c] : dot + s3[c] * q[c];
      }
      st3(z, i, q);
      local = local + dot;
    }
    cluster_pcg::push_sum<T, false>(cl, me, local, red, slots[0], nullptr,
                                    nothing);
    cl.sync();
    const T rz_new = cluster_pcg::slot_total(slots[0]);
    const T beta = rz_new / (rz > T(0) ? rz : T(1));
    rz = rz_new;
    // p = z (k = -1), else z + beta p
    for (int li = tid; li < rows; li += THREADS) {
      const int i = lo + li;
      T q[3], s3[3];
      ld3(z, i, s3);
      ld3(p, i, q);
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c] = k < 0 ? s3[c] : s3[c] + beta * q[c];
      st3(p, i, q);
    }
    cl.sync();
  }

  for (int li = tid; li < rows; li += THREADS) {
    T q[3];
    ld3(xs, lo + li, q);
    st3(x_out, lo + li, q);
  }
}

template <typename T, typename Levels, typename Row>
cudaError_t ready(const Plan& pl) {
  return cluster_pcg::ready((const void*)solve_kernel<T, Levels, Row>,
                           pl.smem_bytes);
}

// The set-up of a solve of n rows, mat_per_row fine matrix values a row
// in shared memory (plan_for_device's D) and nc2 coarsest dofs, without a
// launch: what must run before a CUDA graph captures such solves.
template <typename T, typename Levels, typename Row>
int prepare(int mat_per_row, int n, int nc2) {
  Plan pl;
  const int err = plan_for_device(n, mat_per_row, nc2, sizeof(T), &pl);
  if (err != 0) return err;
  return static_cast<int>(ready<T, Levels, Row>(pl));
}

// The whole solve: its plan, then one launch. host: a Host (GridLevels)
// or an AggHost (AggLevels); scratch: the plan's elements of global
// scratch; x may be x0.
template <typename T, typename Levels, typename Row>
int solve(const Row& row, int mat_per_row, const void* host, const T* b,
          const T* x0, int n, int iters, T* x, T* scratch, void* stream) {
  Levels mg;
  int err = Levels::of(host, &mg);
  if (err != 0) return err;
  if (iters < 0 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  err = plan_for_device(n, mat_per_row, mg.nc2, sizeof(T), &pl);
  if (err != 0) return err;
  cudaError_t e = ready<T, Levels, Row>(pl);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_pcg::cluster_config(
        pl.smem_bytes, static_cast<cudaStream_t>(stream), attr);
    e = cudaLaunchKernelEx(&cfg, solve_kernel<T, Levels, Row>, row, mg, b,
                           x0, n, iters, x, scratch, pl.slab, pl.mat_smem);
  }
  if (e != cudaSuccess) cudaGetLastError();  // returned here, not left behind
  return static_cast<int>(e);
}

}  // namespace mg
}  // namespace admm
