// The multigrid modes of the cluster solve: fixed-budget PCG whose
// preconditioner is a two-coarse-level V-cycle, as ONE launch on ONE
// thread-block cluster. One level form serves both hierarchies:
// aggregates, each level's dofs numbered 0.., R a sum over each
// aggregate's members in a fixed order, P a gather at each dof's
// aggregate, A1 as ELL rows over the level-1 dofs. The algebraic
// multigrid of a mesh of any topology (core/uamg.py) is built so; the
// geometric multigrid of a grid in nested numbering (core/mg.py) is
// converted to it on the host (ops/kernels/mg.py compact_levels: the
// members of a stride block in corner order, A1's rows at the level's
// representatives, slots in diagonal order), dropping only terms that are
// exact zeros, so the solve is the masked hierarchy's.
//
// Replaces: the multigrid mode (mg_meta) of the whole-timestep Pallas
// kernels, admm_elastic_tpu/ops/pallas/banded_step.py:600-739 (the cycle)
// and :924-951 (the PCG around it), and cloth_step.py:457-595 and
// :627-673, whose coarsest product is the kernel's own jnp.dot
// (banded_step.py:689-702): here too it is this kernel's own loop; and
// the algebraic mode (uamg_meta) of banded_step.py, :741-888 and :924-955,
// whose transfer ops, uell slots and (128,128) blocks of A2^-1 are TPU
// layout. The host builds the levels; ops/kernels/uamg.py is the plain
// twin, op for op and sum for sum.
//
// Per PCG iteration, z = V(r) for the three columns of the (n,3) vectors
// in place of z = D^-1 r:
//   A  t  = r - A (om0 r)
//   B  r1 = R0 t;  z1 = om1 r1               (level-1 slab)
//   C  t1 = r1 - A1 z1 at the members of the CTA's coarsest rows
//   D  r2 = R1 t1 at those rows, into every CTA's copy of r2; then z2 =
//      A2^-1 r2 at the same rows, one warp a row (lane l adds j = l,
//      l + 32, ... in turn, then a halving tree over the lanes), into
//      every CTA's copy of z2
//   E  z1 = z1 + z2 at c1                    (level-1 slab, with F)
//   F  z1' = z1 + om1 (r1 - A1 z1)
//   G  zz = om0 r + z1' at c0                (fine slab)
//   H  z = zz + om0 (r - A zz); r.z
// then p = z + beta p, with JAX's rz > 0 and pAp > 0 guards.
//
// What bounds it on this card: on one cluster, L2 latency, the L2
// bandwidth of its 16 SMs, and the stage ends. PR 11's kernel, timed by
// utils/time_solves.py and its stage probe (csrc/probes/mg_stage_probe.cu)
// on the H100: 67 us an iteration at tet100k, 94 at cloth100k, 68 at
// delaunay100k, of which 4-17 us for each level-1 stage that ran over
// every fine row with masked corners and diagonals, 5-18 for the
// coarsest stage that every CTA did whole, ~9-11 for each level-1 ELL
// product whose gathers waited one slot at a time, and 11-12 for each of
// the three fine ELL matvecs, whose 32 slots stream from L2 (4.2 MB each
// time). The design:
// - compact levels, one form: the level-1 stages run over nc1 rows, and
//   a CTA's level-1 rows are the members of its coarsest rows (the host
//   numbers level 1 aggregate by aggregate, uamg.planes_from), so that C
//   reads A1's rows coalesced, as B, E and F do;
// - the coarsest level in shared memory: every CTA holds all of r2 and z2
//   (four values a row), and its own rows of A2^-1 where the plan fits
//   them (read from L2 once a launch, not once an iteration); C and D are
//   one stage split over the CTAs, and each CTA's rows of r2 and of z2
//   reach the others as one bulk copy (cp.async.bulk shared::cta to
//   shared::cluster) each, counted on the receiver's mbarrier: two
//   mbarrier waits in place of a cluster barrier, and no CTA repeats
//   another's work;
// - fewer cluster barriers by recomputation, each recomputed value by the
//   same expression in the same order as its owner's, so of the same
//   bits: E into F (z1 + z2 at c1, z2 from shared memory), always; and
//   where a CTA's slab takes more than FUSE_PASSES passes of its threads,
//   p = z + beta p into A p, the x and r update into A (r double-buffered,
//   so that no CTA overwrites rows a neighbour still reads) and G into H:
//   5 cluster barriers and 2 mbarrier waits an iteration, else 8 and 2
//   (PR 11: 11 barriers). Where the slab takes one or two passes the
//   gathers that fusion adds cost more than the stages it saves (the
//   stage probe runs both);
// - the level-1 rows' gathers unrolled, several slots' loads in flight;
//   the fine and level-1 vectors in global scratch four values a row in
//   f32 (one 16-byte load a gathered row; f64 three values).
// The slab's fine diagonals sit in shared memory where they fit, chosen
// at run time (plan_for_device); a CTA barrier follows their staging
// (read before it, they raced with the previous launch's leftovers).
// ELL fine rows stream from L2 (cg_ell.cu). The iterations are one loop
// whose first pass (k = -1) is the start's V-cycle, with no lambda
// holding the vectors (one that captured them onto the stack cost 7%).
//
// Sums: the matvecs add their diagonals in offset order (ELL rows their
// slots in order), the transfers their members in order, the dots as the
// Jacobi solve (cluster_pcg.cuh), the coarsest rows as above; no atomics,
// so two runs are bitwise equal and the kernel equals its twin bitwise
// (--fmad=false).
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

constexpr int LANES = 32;  // lanes of one coarsest-level row

// The stage ends of an iteration: cluster barriers (fine stages fused or
// not) and mbarrier waits.
constexpr int FUSED_BARRIERS = 5, UNFUSED_BARRIERS = 8, MBARRIER_WAITS = 2;
// The fine stages are fused where a CTA's threads pass over its slab more
// often than this: a stage's passes then wait on L2 one after another
// (stores between them keep the loads of the next in order), and the
// stages that fusion saves cost more than the gathers it adds (H100, the
// stage probe: 8 us each at cloth100k's four passes, 2.5-3.5 at
// tet100k's two).
constexpr int FUSE_PASSES = 2;

// A vector row in global scratch: four values in f32 (one 16-byte load),
// three in f64.
template <typename T>
constexpr int VS = sizeof(T) == 4 ? 4 : 3;

template <typename T>
__device__ __forceinline__ void ldv(const T* v, int j, T c[3]) {
  const T* q = v + VS<T> * static_cast<size_t>(j);
  if constexpr (VS<T> == 4) {
    const float4 f = *reinterpret_cast<const float4*>(q);
    c[0] = f.x;
    c[1] = f.y;
    c[2] = f.z;
  } else {
    c[0] = q[0];
    c[1] = q[1];
    c[2] = q[2];
  }
}

template <typename T>
__device__ __forceinline__ void stv(T* v, int i, const T c[3]) {
  T* q = v + VS<T> * static_cast<size_t>(i);
  if constexpr (VS<T> == 4) {
    *reinterpret_cast<float4*>(q) = make_float4(c[0], c[1], c[2], 0.f);
  } else {
    q[0] = c[0];
    q[1] = c[1];
    q[2] = c[2];
  }
}

// What the C entries take of a multigrid (ops/kernels/uamg.py UAMGHost):
// c0 (n,) int, m1 (M1,nc1) int, l1_idx (K1,nc1) int, l1_vals (K1,nc1),
// om0 (n,), om1 (nc1,), c1 (nc1,) int, m2 (M2,nc2) int, a2inv (nc2,nc2),
// floats in the solve's type, then the sizes. Member lists are
// slot-major, then the level's size (the sentinel: adds 0); A1's empty
// slots hold value 0.
struct Host {
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

template <typename T>
struct Levels {
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

  static int of(const void* host, Levels* out) {
    const Host* h = static_cast<const Host*>(host);
    if (h == nullptr || h->nc1 < 1 || h->M1 < 1 || h->K1 < 1 ||
        h->nc2 < 1 || h->M2 < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    *out = Levels{h->c0,
                  h->m1,
                  h->l1_idx,
                  static_cast<const T*>(h->l1_vals),
                  static_cast<const T*>(h->om0),
                  static_cast<const T*>(h->om1),
                  h->c1,
                  h->m2,
                  static_cast<const T*>(h->a2inv),
                  h->nc1,
                  h->M1,
                  h->K1,
                  h->nc2,
                  h->M2};
    return 0;
  }

  // out = the sum of x over the members of dof i (m: M slots of nc), in
  // order; a sentinel (>= N) adds 0
  static __device__ __forceinline__ void member_sum(
      const int* __restrict__ m, int M, int nc, int N, const T* x, int i,
      T out[3]) {
#pragma unroll 4
    for (int k = 0; k < M; ++k) {
      const int j = m[static_cast<size_t>(k) * nc + i];
      T v[3] = {T(0), T(0), T(0)};
      if (j < N) ldv(x, j, v);
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c] = k == 0 ? v[c] : out[c] + v[c];
    }
  }

  // out = row i of A1 y, the slots in order, where col(j, c) writes y's
  // row j to c[0..2]
  template <typename Col>
  __device__ __forceinline__ void l1_row(int i, const Col& col,
                                         T out[3]) const {
    T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll(sizeof(T) == 4 ? 8 : 4)
    for (int k = 0; k < K1; ++k) {
      const size_t q = static_cast<size_t>(k) * nc1 + i;
      const T w = l1_vals[q];
      T c[3];
      col(l1_idx[q], c);
      a0 = a0 + w * c[0];
      a1 = a1 + w * c[1];
      a2 = a2 + w * c[2];
    }
    out[0] = a0;
    out[1] = a1;
    out[2] = a2;
  }
};

// The solve's vectors in global scratch, VS values a row: the fine level's
// (r and p two each, a pass reading one and writing the other) and level
// 1's.
enum FineVector { R0, R1, P0, P1, AP, X, Z, TT, N_FINE };
enum LevelVector { L_R1, L_Z1, L_Z1B, N_LEVEL };

// Round a count of values up to 4 (16-byte-aligned regions).
__host__ __device__ inline long long round4(long long v) {
  return (v + 3) / 4 * 4;
}

// Shared memory, in elements of T: r2 and z2 (4 values a row), t1 at the
// CTA's level-1 rows (the members of its coarsest rows, at most S2 x M2;
// 4 values each), then where the plan fits them the slab's fine
// diagonals and the CTA's rows of A2^-1.
__host__ __device__ inline long long coarse_region(int nc2, int S2, int M2) {
  return 8LL * nc2 + 4LL * S2 * M2;
}

struct Plan {
  int slab, slab2;         // rows a CTA owns: fine, coarsest
  int fuse;                // 1: the fine stages fused (more than FUSE_PASSES
                           // passes of a CTA's threads over its slab)
  int mat;                 // fine matrix values a row it may stage (D)
  int mat_smem;            // 1: the slab's fine diagonals in shared memory
  int a2_smem;             // 1: the CTA's rows of A2^-1 in shared memory
  int smem_bytes;          // dynamic shared memory a CTA
  long long scratch;       // elements of global scratch
};

// D: the fine rows' matrix values a row staged in shared memory when they
// fit (dia: the diagonals; ELL rows: 0, they stream from L2). The fine
// diagonals, read three times an iteration, take the room first; the
// rows of A2^-1, read once, what is left.
inline int plan_for_device(int n, int D, const Host& h, int elem,
                           Plan* out) {
  if (n < 1 || D < 0 || h.nc1 < 1 || h.nc2 < 1 || h.M2 < 1 ||
      (elem != 4 && elem != 8))
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
  p.fuse = p.slab > FUSE_PASSES * THREADS;
  p.slab2 = (h.nc2 + CLUSTER - 1) / CLUSTER;
  p.mat = D;
  const long long fixed = coarse_region(h.nc2, p.slab2, h.M2) * elem;
  const long long mat = static_cast<long long>(D) * p.slab * elem;
  const long long a2 =
      round4(static_cast<long long>(p.slab2) * h.nc2) * elem;
  if (fixed > limit) return static_cast<int>(cudaErrorInvalidValue);
  p.mat_smem = D > 0 && fixed + mat <= limit;
  const long long used = fixed + (p.mat_smem ? mat : 0);
  p.a2_smem = used + a2 <= limit;
  p.smem_bytes = static_cast<int>(used + (p.a2_smem ? a2 : 0));
  p.scratch = static_cast<long long>(elem == 4 ? 4 : 3) *
              (static_cast<long long>(N_FINE) * n +
               static_cast<long long>(N_LEVEL) * h.nc1);
  *out = p;
  return 0;
}

// The stamps a pass may write under PROBE (its stage ends, in order; the
// start's pass leaves the first one or two out), and the stages' names.
constexpr int STAGE_SLOTS = 10;
constexpr const char* FUSED_STAGES =
    "P: p, Ap, p.Ap|A: x, r, t|B: r1, z1|CD: t1, r2|D: z2|EF: z1'|"
    "GH: z, r.z";
constexpr const char* UNFUSED_STAGES =
    "P: Ap, p.Ap|x, r|A: t|B: r1, z1|CD: t1, r2|D: z2|EF: z1'|G: zz|"
    "H: z, r.z|p";

template <bool PROBE>
__device__ __forceinline__ void stamp(unsigned long long* stamps, int me,
                                      int slot) {
  if constexpr (PROBE) {
    if (me == 0 && threadIdx.x == 0) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      stamps[slot] = t;
    }
  }
}

// Solves A X = B, (n,3) row-major, by `iters` V-cycle PCG iterations from
// x0; x_out may be x0 (x0 is read before the first stage end only, x_out
// written after the last). g: the plan's scratch. FUSE: the fine stages'
// recomputation (see the note at the top); PROBE: the stamps.
template <typename T, typename Row, bool FUSE, bool PROBE>
__global__ void __launch_bounds__(THREADS, 1)
    solve_kernel(const __grid_constant__ Row row,
                 const __grid_constant__ Levels<T> mg,
                 const T* __restrict__ b, const T* x0, int n, int iters,
                 T* x_out, T* g, const __grid_constant__ Plan pl,
                 unsigned long long* stamps) {
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  // every rank's partials: [0] r.z, [1] p.Ap
  __shared__ T slots[2][CLUSTER];
  __shared__ T red[WARPS];
  __shared__ __align__(8) uint64_t bars[2];  // r2's rows, z2's rows
  cgr::cluster_group cl = cgr::this_cluster();
  const int me = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc1 = mg.nc1, nc2 = mg.nc2, M2 = mg.M2;
  const int lo = min(me * pl.slab, n), rows = min(lo + pl.slab, n) - lo;
  const int k0 = min(me * pl.slab2, nc2);
  const int nk = min(k0 + pl.slab2, nc2) - k0;
  // the level-1 rows: the members of the CTA's coarsest rows, consecutive
  // in the numbering uamg.planes_from gives (aggregate by aggregate, an
  // aggregate's first member in slot 0 of m2)
  const int lo1 = k0 < nc2 ? mg.m2[k0] : nc1;
  const int rows1 = (k0 + nk < nc2 ? mg.m2[k0 + nk] : nc1) - lo1;
  T* const r2s = reinterpret_cast<T*>(dyn_raw);
  T* const z2s = r2s + 4 * nc2;
  T* const t1s = z2s + 4 * nc2;
  T* const tail = r2s + coarse_region(nc2, pl.slab2, M2);
  T* const a2s =
      tail + (pl.mat_smem ? static_cast<long long>(pl.mat) * pl.slab : 0);
  if (tid == 0) {
    for (int q = 0; q < 2; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       cluster_pcg::smem_addr(&bars[q]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const typename Row::View mv =
      row.stage(lo, rows, pl.mat_smem ? tail : nullptr);
  const T* a2 = mg.a2inv + static_cast<size_t>(k0) * nc2;
  if (pl.a2_smem) {
    for (int q = tid; q < nk * nc2; q += THREADS) a2s[q] = a2[q];
    a2 = a2s;
  }
  constexpr int V = VS<T>;
  const size_t gn = V * static_cast<size_t>(n);
  const size_t g1 = V * static_cast<size_t>(nc1);
  T* const aps = g + AP * gn;
  T* const xs = g + X * gn;
  T* const z = g + Z * gn;
  T* const tt = g + TT * gn;  // t; then zz (!FUSE)
  T* const r1 = g + N_FINE * gn + L_R1 * g1;
  T* const z1 = g + N_FINE * gn + L_Z1 * g1;
  T* const z1b = g + N_FINE * gn + L_Z1B * g1;
  auto nothing = [] {};
  const uint32_t pushed = 4 * sizeof(T) * nk;  // bytes of the CTA's rows
  const uint32_t expected = 4 * sizeof(T) * (nc2 - nk);
  __syncthreads();  // the staged matrix rows, A2^-1 rows and offsets

  // r = b - A x0; x = x0
  for (int li = tid; li < rows; li += THREADS) {
    const int i = lo + li;
    T ax[3], q[3];
    row(mv, i, li,
        [&](int j, T c[3]) {
          const T* s = x0 + 3 * static_cast<size_t>(j);
          c[0] = s[0];
          c[1] = s[1];
          c[2] = s[2];
        },
        ax);
#pragma unroll
    for (int c = 0; c < 3; ++c) q[c] = x0[3 * static_cast<size_t>(i) + c];
    stv(xs, i, q);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      q[c] = b[3 * static_cast<size_t>(i) + c] - ax[c];
    stv(g + R0 * gn, i, q);
  }
  stamp<PROBE>(stamps, me, 0);
  cl.sync();  // every CTA has started; r is written; the mbarriers are set
  stamp<PROBE>(stamps, me, 1);

  // k = -1: z = V(r0); then the iterations
  T rz = T(0), beta = T(0);
  for (int k = -1; k < iters; ++k) {
    const int ph = (k + 1) & 1;  // the pass's parity
    // r and p two buffers each (no array: indexed at run time, it would
    // live on the stack)
    T* const r = g + (R0 + ph) * gn;  // the V-cycle's r
    const T* const r_old = g + (R0 + (ph ^ 1)) * gn;
    T* const p = g + (P0 + (k & 1)) * gn;  // this iteration's p
    const T* const p_old = g + (P0 + ph) * gn;
    // the pass's stamp slot (the start's pass has no P or x, r stage)
    int s = 2 + STAGE_SLOTS * (k + 1) + (k < 0 ? (FUSE ? 1 : 2) : 0);
    T alpha = T(0);
    if (k >= 0) {
      // P. (FUSE: p = z + beta p_old, recomputed at the neighbours) A p
      // and p.Ap over the slab
      auto pcol = [&](int j, T c[3]) {
        if constexpr (FUSE) {
          ldv(z, j, c);
          if (k > 0) {
            T q[3];
            ldv(p_old, j, q);
#pragma unroll
            for (int e = 0; e < 3; ++e) c[e] = c[e] + beta * q[e];
          }
        } else {
          ldv(p, j, c);
        }
      };
      T local = T(0);
      for (int li = tid; li < rows; li += THREADS) {
        const int i = lo + li;
        T ap[3], q[3];
        pcol(i, q);
        if constexpr (FUSE) stv(p, i, q);
        row(mv, i, li, pcol, ap);
        stv(aps, i, ap);
        T dot = T(0);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          dot = c == 0 ? q[c] * ap[c] : dot + q[c] * ap[c];
        local = local + dot;
      }
      cluster_pcg::push_sum<T, false>(cl, me, local, red, slots[1], nullptr,
                                      nothing);
      cl.sync();
      stamp<PROBE>(stamps, me, s++);
      const T pAp = cluster_pcg::slot_total(slots[1]);
      alpha = rz / (pAp > T(0) ? pAp : T(1));
      if constexpr (!FUSE) {
        // x += alpha p; r = r_old - alpha Ap
        for (int li = tid; li < rows; li += THREADS) {
          const int i = lo + li;
          T q[3], x3[3], r3[3], a3[3];
          ldv(p, i, q);
          ldv(xs, i, x3);
          ldv(r_old, i, r3);
          ldv(aps, i, a3);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            x3[c] = x3[c] + alpha * q[c];
            r3[c] = r3[c] - alpha * a3[c];
          }
          stv(xs, i, x3);
          stv(r, i, r3);
        }
        cl.sync();
        stamp<PROBE>(stamps, me, s++);
      }
    }
    // A. (FUSE: x += alpha p; r = r_old - alpha Ap, recomputed at the
    // neighbours) t = r - A (om0 r)
    const bool update = FUSE && k >= 0;
    auto rcol = [&](int j, T c[3]) {
      if (update) {
        T a3[3];
        ldv(r_old, j, c);
        ldv(aps, j, a3);
#pragma unroll
        for (int e = 0; e < 3; ++e) c[e] = c[e] - alpha * a3[e];
      } else {
        ldv(r, j, c);
      }
    };
    for (int li = tid; li < rows; li += THREADS) {
      const int i = lo + li;
      T az[3], q[3];
      rcol(i, q);
      if (update) {
        T x3[3], p3[3];
        ldv(xs, i, x3);
        ldv(p, i, p3);
#pragma unroll
        for (int c = 0; c < 3; ++c) x3[c] = x3[c] + alpha * p3[c];
        stv(xs, i, x3);
        stv(r, i, q);
      }
      row(mv, i, li,
          [&](int j, T c[3]) {
            const T o = mg.om0[j];
            rcol(j, c);
            c[0] = o * c[0];
            c[1] = o * c[1];
            c[2] = o * c[2];
          },
          az);
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c] = q[c] - az[c];
      stv(tt, i, q);
    }
    cl.sync();
    stamp<PROBE>(stamps, me, s++);
    // B. r1 = R0 t; z1 = om1 r1 over the level-1 slab
    for (int li = tid; li < rows1; li += THREADS) {
      const int i = lo1 + li;
      T q[3];
      Levels<T>::member_sum(mg.m1, mg.M1, nc1, n, tt, i, q);
      stv(r1, i, q);
      const T o = mg.om1[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c] = o * q[c];
      stv(z1, i, q);
    }
    cl.sync();
    stamp<PROBE>(stamps, me, s++);
    // C. t1 = r1 - A1 z1 over the level-1 slab, the members of the CTA's
    // coarsest rows, into shared memory
    auto z1col = [&](int j, T c[3]) { ldv(z1, j, c); };
    for (int li = tid; li < rows1; li += THREADS) {
      T az[3], v[3];
      mg.l1_row(lo1 + li, z1col, az);
      ldv(r1, lo1 + li, v);
#pragma unroll
      for (int c = 0; c < 3; ++c) t1s[4 * li + c] = v[c] - az[c];
    }
    __syncthreads();
    // D. r2 = R1 t1 at the CTA's rows, the members in slot order: an
    // aggregate's are consecutive, from its slot-0 member to the next
    // aggregate's, and its sentinel slots add 0; the rows to every other
    // CTA (one bulk copy each, counted on its bars[0])
    for (int kk = tid; kk < nk; kk += THREADS) {
      const int k = k0 + kk;
      const int first = mg.m2[k] - lo1;
      const int size = (k + 1 < nc2 ? mg.m2[k + 1] : nc1) - lo1 - first;
      T acc[3];
      for (int slot = 0; slot < M2; ++slot) {
        T y[3] = {T(0), T(0), T(0)};
        if (slot < size) {
#pragma unroll
          for (int c = 0; c < 3; ++c) y[c] = t1s[4 * (first + slot) + c];
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = slot == 0 ? y[c] : acc[c] + y[c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) r2s[4 * k + c] = acc[c];
    }
    cluster_pcg::fence_async();
    __syncthreads();
    if (warp == 0 && lane < CLUSTER && lane != me && nk > 0)
      cluster_pcg::bulk_push(r2s + 4 * k0, r2s + 4 * k0, pushed, &bars[0],
                             lane);
    if (tid == 0) cluster_pcg::mbar_expect(&bars[0], expected);
    cluster_pcg::mbar_wait(&bars[0], ph);
    stamp<PROBE>(stamps, me, s++);
    // z2 = A2^-1 r2 at the CTA's rows, one warp a row; the rows to every
    // other CTA (bars[1])
    for (int kr = warp; kr < nk; kr += WARPS) {
      const T* ak = a2 + static_cast<size_t>(kr) * nc2;
      T a0 = T(0), a1 = T(0), a2v = T(0);
      for (int j = lane; j < nc2; j += LANES) {
        const T w = ak[j];
        a0 = a0 + w * r2s[4 * j];
        a1 = a1 + w * r2s[4 * j + 1];
        a2v = a2v + w * r2s[4 * j + 2];
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1) {
        a0 = a0 + __shfl_down_sync(FULL, a0, off);
        a1 = a1 + __shfl_down_sync(FULL, a1, off);
        a2v = a2v + __shfl_down_sync(FULL, a2v, off);
      }
      if (lane == 0) {
        T* out = z2s + 4 * (k0 + kr);
        out[0] = a0;
        out[1] = a1;
        out[2] = a2v;
      }
    }
    cluster_pcg::fence_async();
    __syncthreads();
    if (warp == 0 && lane < CLUSTER && lane != me && nk > 0)
      cluster_pcg::bulk_push(z2s + 4 * k0, z2s + 4 * k0, pushed, &bars[1],
                             lane);
    if (tid == 0) cluster_pcg::mbar_expect(&bars[1], expected);
    cluster_pcg::mbar_wait(&bars[1], ph);
    stamp<PROBE>(stamps, me, s++);
    // E, F. z1' = z1e + om1 (r1 - A1 z1e), z1e = z1 + z2 at c1 (recomputed
    // at every column), over the level-1 slab
    auto z1e = [&](int j, T c[3]) {
      ldv(z1, j, c);
      const T* q = z2s + 4 * mg.c1[j];
      c[0] = c[0] + q[0];
      c[1] = c[1] + q[1];
      c[2] = c[2] + q[2];
    };
    for (int li = tid; li < rows1; li += THREADS) {
      const int i = lo1 + li;
      T az[3], q[3], s3[3];
      z1e(i, q);
      mg.l1_row(i, z1e, az);
      ldv(r1, i, s3);
      const T o = mg.om1[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c] = q[c] + o * (s3[c] - az[c]);
      stv(z1b, i, q);
    }
    cl.sync();
    stamp<PROBE>(stamps, me, s++);
    // G. zz = om0 r + z1' at c0 (FUSE: recomputed at every column of H)
    auto zzcol = [&](int j, T c[3]) {
      T w[3];
      ldv(r, j, c);
      const T o = mg.om0[j];
      ldv(z1b, mg.c0[j], w);
#pragma unroll
      for (int e = 0; e < 3; ++e) c[e] = o * c[e] + w[e];
    };
    if constexpr (!FUSE) {
      for (int li = tid; li < rows; li += THREADS) {
        T q[3];
        zzcol(lo + li, q);
        stv(tt, lo + li, q);
      }
      cl.sync();
      stamp<PROBE>(stamps, me, s++);
    }
    // H. z = zz + om0 (r - A zz); r.z
    auto hcol = [&](int j, T c[3]) {
      if constexpr (FUSE)
        zzcol(j, c);
      else
        ldv(tt, j, c);
    };
    T local = T(0);
    for (int li = tid; li < rows; li += THREADS) {
      const int i = lo + li;
      T az[3], q[3], s3[3];
      hcol(i, q);
      row(mv, i, li, hcol, az);
      ldv(r, i, s3);
      const T o = mg.om0[i];
      T dot = T(0);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q[c] = q[c] + o * (s3[c] - az[c]);
        dot = c == 0 ? s3[c] * q[c] : dot + s3[c] * q[c];
      }
      stv(z, i, q);
      local = local + dot;
    }
    cluster_pcg::push_sum<T, false>(cl, me, local, red, slots[0], nullptr,
                                    nothing);
    cl.sync();
    stamp<PROBE>(stamps, me, s++);
    const T rz_new = cluster_pcg::slot_total(slots[0]);
    beta = rz_new / (rz > T(0) ? rz : T(1));
    rz = rz_new;
    if constexpr (!FUSE) {
      // p = z (k = -1), else z + beta p, into the next iteration's buffer
      T* const pn = g + (P0 + ((k + 1) & 1)) * gn;
      for (int li = tid; li < rows; li += THREADS) {
        const int i = lo + li;
        T q[3], s3[3];
        ldv(z, i, s3);
        if (k >= 0) ldv(p, i, q);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          q[c] = k < 0 ? s3[c] : s3[c] + beta * q[c];
        stv(pn, i, q);
      }
      cl.sync();
      stamp<PROBE>(stamps, me, s++);
    }
  }

  for (int li = tid; li < rows; li += THREADS) {
    T q[3];
    ldv(xs, lo + li, q);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      x_out[3 * static_cast<size_t>(lo + li) + c] = q[c];
  }
}

template <typename T, typename Row, bool PROBE>
const void* kernel_of(int fuse) {
  return fuse ? (const void*)solve_kernel<T, Row, true, PROBE>
              : (const void*)solve_kernel<T, Row, false, PROBE>;
}

// The set-up of a solve of n rows, mat_per_row fine matrix values a row
// in shared memory (plan_for_device's D) and the multigrid `host` (a
// Host), without a launch: what must run before a CUDA graph captures
// such solves.
template <typename T, typename Row>
int prepare(int mat_per_row, int n, const void* host) {
  if (host == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int err = plan_for_device(
      n, mat_per_row, *static_cast<const Host*>(host), sizeof(T), &pl);
  if (err != 0) return err;
  return static_cast<int>(
      cluster_pcg::ready(kernel_of<T, Row, false>(pl.fuse), pl.smem_bytes));
}

// The whole solve: its plan, then one launch. host: a Host; scratch: the
// plan's elements of global scratch; x may be x0. fuse: the fine stages
// fused (1) or not (0), or as the plan picks (-1).
template <typename T, typename Row, bool PROBE = false>
int solve(const Row& row, int mat_per_row, const void* host, const T* b,
          const T* x0, int n, int iters, T* x, T* scratch, void* stream,
          unsigned long long* stamps = nullptr, int fuse = -1) {
  Levels<T> mg;
  int err = Levels<T>::of(host, &mg);
  if (err != 0) return err;
  if (iters < 0 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  err = plan_for_device(n, mat_per_row, *static_cast<const Host*>(host),
                        sizeof(T), &pl);
  if (err != 0) return err;
  if (fuse >= 0) pl.fuse = fuse;
  const void* fn = kernel_of<T, Row, PROBE>(pl.fuse);
  cudaError_t e = cluster_pcg::ready(fn, pl.smem_bytes);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_pcg::cluster_config(
        pl.smem_bytes, static_cast<cudaStream_t>(stream), attr);
    e = pl.fuse ? cudaLaunchKernelEx(&cfg, solve_kernel<T, Row, true, PROBE>,
                                     row, mg, b, x0, n, iters, x, scratch,
                                     pl, stamps)
                : cudaLaunchKernelEx(&cfg, solve_kernel<T, Row, false, PROBE>,
                                     row, mg, b, x0, n, iters, x, scratch,
                                     pl, stamps);
  }
  if (e != cudaSuccess) cudaGetLastError();  // returned here, not left behind
  return static_cast<int>(e);
}

}  // namespace mg
}  // namespace admm
