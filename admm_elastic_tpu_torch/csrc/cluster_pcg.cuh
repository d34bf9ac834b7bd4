// Fixed-budget Jacobi-PCG as ONE launch on ONE thread-block cluster: the
// whole-solve entry points cg_dia_solve (cg_dia.cu) and cg_ell_solve
// (cg_ell.cu), which differ only in the row of the matvec.
//
// Solves A X = B for X, B of shape (n,3) row-major; the three columns are
// one system, so alpha and beta are single scalars over all 3n values,
// with the pAp > 0 and rz > 0 guards of core/solver.pcg_fixed_inv, and 0
// iterations return x0.
//
// Slabs. The cluster's CLUSTER = 16 CTAs (fixed at compile time: the
// size fixes the order of the sums; 8 CTAs took 1.8x and 1.4x longer on
// the dia and ELL presets) split the rows into slabs of S = ceil(n / 16);
// CTA `rank` owns rows [rank S, (rank + 1) S), which its THREADS threads
// walk as t, t + THREADS, ... Row i reads columns within H of i (H: the
// largest |offset| of the dia matrix, the largest |idx - i| of the ELL
// one). Only the matrix's ends give 0: a slab edge inside a band row
// reads the neighbour's rows. Two layouts, chosen by make_plan:
//
// WINDOW, when a CTA's window of the vectors, rows [lo - H, hi + H)
// (clipped to the matrix) of r, D^-1 and p besides its slab's x and A p,
// fits in shared memory. No CTA reads another's memory: each one PUSHES
// what the others need with remote stores: after updating r, its rows
// within H of the slab's edges, into the windows that hold them; every
// dot's partial, into every CTA's slot for it. A CTA then computes p =
// D^-1 r + beta p over its whole window itself: the halo's p comes out
// bitwise as its owner's, from the same r, D^-1 and old p in the same
// expression. (Reading the neighbours' p and the partials through
// distributed shared memory cost more than the barriers: each remote load
// is a round trip, serialised at the SM that serves it.) An iteration is
// two stages, each ending when a CTA has what the next needs:
//   1. p over the window (a CTA barrier); Ap = A p over the slab; p.Ap
//   2. alpha; x += alpha p; r -= alpha Ap; push the edge rows of r;
//      r.(D^-1 r)
// A window row is (r, D^-1), 16 bytes in f32, so the rows another CTA
// needs are one aligned block: one bulk copy (cp.async.bulk, shared::cta
// to shared::cluster) a receiving CTA, and each partial an st.async; both
// count their bytes on the receiver's mbarrier (one per kind of stage),
// and a CTA waits on its own mbarrier for the bytes it expects: no cluster
// barrier inside the loop. Data of one kind of stage can only be sent once
// every CTA has finished the stage of the other kind in between, so one
// buffer of each kind suffices and no phase takes another phase's bytes;
// a sender rewrites a pushed row only after its receiver has answered
// with the next partial, so the copy has read it.
//
// SHARED, when the window does not fit (a band like tet100k's past ~25,000
// rows in f64, ~60,000 in f32; a numbering whose rows reach far, as a mesh
// numbered without regard to its band has, where every window is the whole
// vector): one p of all n rows in global memory, each CTA writing its own
// slab's rows (in f32 four values a row, so that a gathered row is one
// load), and the slab's r, D^-1, x and A p beside it. A window there
// would make every CTA recompute p over all of it and write its r rows
// into every other window. An iteration is three stages, each ended by
// cluster.sync() (barrier.cluster arrive.release / wait.acquire; never a
// grid barrier), the partials sent as plain remote stores:
//   1. p over the slab
//   2. Ap = A p over the slab, reading p anywhere; p.Ap
//   3. alpha; x += alpha p; r -= alpha Ap; r.(D^-1 r)
// A cluster barrier also opens the solve (every CTA has started, its
// mbarriers are set up) and closes it (no CTA exits while another may
// still write to it).
//
// Dot products: every thread adds its rows' values in turn, each row the
// three products in order; the CTA adds its threads by a halving tree
// within each warp of 32 and then over the 32 warps; every CTA adds the 16
// partials in rank order. So every CTA holds the same alpha and beta, with
// no atomics, two runs are bitwise equal, and both layouts give the same
// bits (ops/kernels/cg_step.cluster_dot is the same order in PyTorch).
#pragma once

#include <cooperative_groups.h>

#include <atomic>
#include <cstdint>
#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <utility>

#include "common.cuh"

namespace admm {
namespace cluster_pcg {

namespace cgr = cooperative_groups;

constexpr int CLUSTER = 16;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
static_assert(WARPS == 32, "the CTA sum is two warp trees of 32");
static_assert(CLUSTER <= 32, "warp 0 sends the partials, one lane a CTA");
constexpr unsigned FULL = 0xffffffffu;
// Upper bound of the kernel's static shared memory (slots, warp sums, a
// row's offsets); the rest of the card's opt-in limit is for the slab
constexpr int STATIC_SMEM = 1024;

struct Plan {
  int slab;           // S: rows a CTA owns
  int window;         // W: rows of a CTA's window (WINDOW), else S
  int vec_smem;       // 1: WINDOW, the vectors in shared memory; 0: SHARED
  int mat_smem;       // 1: the slab's matrix rows are in shared memory
  int smem_bytes;     // dynamic shared memory a CTA
  long long scratch;  // elements of global scratch (0 with WINDOW)
};

// What a CTA of a solve keeps in shared memory in the WINDOW layout, in
// elements of T: per row of its window and per row of its slab; and
// what the SHARED layout keeps in global scratch per row of the matrix.
struct Vectors {
  int per_window, per_slab, scratch_per_row;
};

// The PCG's: the window's rows of (r, D^-1), four values a row so that a
// run of rows is a 16-byte-aligned block, and of p (3); the slab's x and
// Ap (3 each). SHARED: (r, D^-1) of all rows, four values a row so that a
// row is one aligned load (first, so 16-byte aligned), room for p at four
// values a row, then x and Ap (3 n each).
constexpr Vectors PCG_VECTORS = {7, 6, 14};

// A WINDOW CTA's shared memory for its vectors, in elements of T, rounded
// up to 4 values, so that the matrix rows after it start 16-byte aligned.
__host__ __device__ inline long long region(long long window, long long slab,
                                            int per_window = 7,
                                            int per_slab = 6) {
  return (per_window * window + per_slab * slab + 3) / 4 * 4;
}

// H: how far a row reaches; mat_per_row: elements of T the row type keeps
// per slab row in shared memory when they fit (dia: D; ell: 0); limit: the
// dynamic shared memory a CTA may use; v: the solve's vectors.
inline Plan make_plan(int n, int H, int mat_per_row, int elem, int limit,
                      Vectors v = PCG_VECTORS) {
  Plan p;
  p.slab = (n + CLUSTER - 1) / CLUSTER;
  const long long reach = static_cast<long long>(p.slab) + 2LL * H;
  const int window = static_cast<int>(reach < n ? reach : n);
  const long long vec =
      region(window, p.slab, v.per_window, v.per_slab) * elem;
  const long long mat = static_cast<long long>(mat_per_row) * p.slab * elem;
  p.vec_smem = vec <= limit;
  p.window = p.vec_smem ? window : p.slab;
  const long long used = p.vec_smem ? vec : 0;
  p.mat_smem = mat_per_row > 0 && used + mat <= limit;
  p.smem_bytes = static_cast<int>(used + (p.mat_smem ? mat : 0));
  p.scratch = p.vec_smem ? 0 : static_cast<long long>(v.scratch_per_row) * n;
  return p;
}

// The plan on the current device, whose opt-in shared memory a CTA is
// asked once a device.
inline int plan_for_device(int n, int H, int mat_per_row, int elem,
                           Plan* out, Vectors v = PCG_VECTORS) {
  if (n < 1 || H < 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int MAX_DEVICES = 64;
  static std::atomic<int> optin[MAX_DEVICES];  // 0: not asked yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  int limit = optin[dev].load(std::memory_order_relaxed);
  if (limit == 0) {
    e = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    optin[dev].store(limit, std::memory_order_relaxed);
  }
  *out = make_plan(n, H, mat_per_row, elem, limit - STATIC_SMEM, v);
  return 0;
}

// A window row of (r, D^-1) in one or two 16-byte accesses.
__device__ __forceinline__ void ld4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void ld4(const double* p, double v[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void st4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(double* p, const double v[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t remote_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// v to rank's copy of `dst` (shared memory), its bytes counted on rank's
// copy of `bar`.
__device__ __forceinline__ void st_async(float* dst, float v, uint64_t* bar,
                                         int rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(remote_addr(dst, rank)),
      "r"(__float_as_uint(v)), "r"(remote_addr(bar, rank))
      : "memory");
}

__device__ __forceinline__ void st_async(double* dst, double v,
                                         uint64_t* bar, int rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];" ::"r"(remote_addr(dst, rank)),
      "l"(__double_as_longlong(v)), "r"(remote_addr(bar, rank))
      : "memory");
}

// bytes (a multiple of 16) from this CTA's shared memory at src to rank's
// copy of dst, by the bulk-copy unit, counted on rank's copy of `bar`. The
// block's writes must be made visible to it first (fence_async).
__device__ __forceinline__ void bulk_push(const void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          int rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(remote_addr(dst, rank)),
      "r"(smem_addr(src)), "r"(bytes), "r"(remote_addr(bar, rank))
      : "memory");
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One arrival on the CTA's own mbarrier, expecting `bytes` more bytes in
// the current phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of the given parity to complete. A wait of seconds
// means a count that can never be met: trap rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 33)) __trap();
  }
}

// The CTA's sum of one value a thread (warp trees), pushed by warp 0 into
// slot[me] of every CTA of the cluster (ASYNC: an st.async counted on its
// `bar`; else a plain remote store; its own slot is a plain store). Warp 1
// runs `edges` after the CTA barrier.
template <typename T, bool ASYNC, typename Edges>
__device__ __forceinline__ void push_sum(cgr::cluster_group& cl, int me,
                                         T v, T* red, T* slot, uint64_t* bar,
                                         const Edges& edges) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_down_sync(FULL, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 1) edges();
  if (warp == 0) {
    v = red[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = v + __shfl_down_sync(FULL, v, off);
    v = __shfl_sync(FULL, v, 0);
    if (lane == me)
      slot[me] = v;
    else if (lane < CLUSTER && ASYNC)
      st_async(slot + me, v, bar, lane);
    else if (lane < CLUSTER)
      *cl.map_shared_rank(slot + me, lane) = v;
    __syncwarp();  // this CTA's own partial before thread 0's arrival
  }
}

// The CLUSTER partials of a slot, in rank order.
template <typename T>
__device__ __forceinline__ T slot_total(const T* slot) {
  T acc = T(0);
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) acc = acc + slot[r];
  return acc;
}

// Row concept: Row::View stage(lo, rows, smem) is called by every thread
// of a CTA (a barrier follows) and returns what operator() needs; smem is
// the CTA's room for its slab's matrix, or nullptr.
// row(view, i, li, col, out) writes row i (the slab's li-th) of A y, where
// col(j, c) writes y's row j to c[0..2].
// WINDOW: the layout in shared memory (else SHARED, in `scratch`).
// diag_inv: diag holds D^-1 itself (else A's diagonal, inverted here).
// x_out may be x0 (the whole-timestep steppers solve in place): x0 is
// read before the first stage end only, which no CTA passes before every
// CTA has read its rows, and x_out is written after the last.
template <typename T, typename Row, bool WINDOW>
__global__ void __launch_bounds__(THREADS, 1)
    solve_kernel(const Row row, const T* __restrict__ b, const T* x0,
                 const T* __restrict__ diag, int diag_inv, int n, int H,
                 int iters, T* x_out, T* scratch, int S, int W,
                 int mat_smem) {
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  // every rank's partials: [0] r.(D^-1 r), [1] p.Ap
  __shared__ T slots[2][CLUSTER];
  __shared__ __align__(8) uint64_t bars[2];  // WINDOW: their mbarriers
  __shared__ T red[WARPS];
  cgr::cluster_group cl = cgr::this_cluster();
  const int me = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x;
  const int lo = min(me * S, n), rows = min(lo + S, n) - lo, hi = lo + rows;
  // WINDOW: rows [wlo, wlo + wn), none for a CTA without rows; SHARED: the
  // slab
  const int wlo = WINDOW && rows ? max(lo - H, 0) : lo;
  const int wn = !WINDOW ? rows : rows ? min(hi + H, n) - wlo : 0;
  const size_t s = S, w = W;
  T* dyn = reinterpret_cast<T*>(dyn_raw);
  if (WINDOW && tid == 0) {
    for (int q = 0; q < 2; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&bars[q]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const typename Row::View mv = row.stage(
      lo, rows, mat_smem ? dyn + (WINDOW ? region(W, S) : 0) : nullptr);
  const size_t gn = n;
  T* rd = WINDOW ? dyn : scratch + 4 * static_cast<size_t>(lo);  // r, D^-1
  // p: three values a row; SHARED f32 four (one aligned load a row; in
  // f64 the extra bytes cost more than the loads they save)
  constexpr int PS = WINDOW || sizeof(T) == 8 ? 3 : 4;
  T* pw = WINDOW ? dyn + 4 * w : scratch + 4 * gn + PS * lo;
  T* xs = WINDOW ? dyn + 7 * w : scratch + 8 * gn + 3 * lo;  // slab x
  T* aps = WINDOW ? xs + 3 * s : scratch + 11 * gn + 3 * lo;  // slab Ap
  const int off = lo - wlo;  // a slab row's place in the window
  for (int q = tid; q < wn; q += THREADS)
    rd[4 * q + 3] = diag_inv ? diag[wlo + q] : T(1) / diag[wlo + q];
  cl.sync();  // every CTA has started before any writes to another

  // WINDOW: the slab's rows of (r, D^-1) that other CTAs' windows hold,
  // into those windows, one bulk copy a window, by warp 1 once the CTA's
  // rows are written.
  const int t_first = rows ? max(lo - H, 0) / S : 0;
  const int t_last = rows ? min(hi - 1 + H, n - 1) / S : -1;
  auto push_edges = [&]() {
    if (!WINDOW) return;
    for (int t = t_first + (tid & 31); t <= t_last; t += 32) {
      const int tlo = max(t * S - H, 0);
      const int a = max(lo, tlo), e = min(hi, min(t * S + S + H, n));
      if (t != me && a < e)
        bulk_push(rd + 4 * (a - tlo), rd + 4 * (a - wlo),
                  4 * sizeof(T) * (e - a), &bars[0], t);
    }
  };
  auto nothing = [] {};
  // The end of a stage whose partials are in slots[kind], the kind's
  // `phase`-th (WINDOW: the other partials and, for r, the window's halo
  // rows have landed).
  const uint32_t halo = 4 * sizeof(T) * (wn - rows);
  auto stage_end = [&](int kind, int phase) {
    if (WINDOW) {
      if (tid == 0)
        mbar_expect(&bars[kind],
                    (CLUSTER - 1) * sizeof(T) + (kind == 0 ? halo : 0));
      mbar_wait(&bars[kind], phase & 1);
    } else {
      cl.sync();
    }
  };

  // r = b - A x0; x = x0; r.(D^-1 r)
  T local = T(0);
  for (int li = tid; li < rows; li += THREADS) {
    const int i = lo + li;
    T ax[3];
    row(mv, i, li,
        [&](int j, T c[3]) {
          const T* q = x0 + 3 * static_cast<size_t>(j);
          c[0] = q[0];
          c[1] = q[1];
          c[2] = q[2];
        },
        ax);
    T* r4 = rd + 4 * (off + li);
    const T d = r4[3];
    T dot = T(0);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const size_t g = 3 * static_cast<size_t>(i) + c;
      xs[3 * li + c] = x0[g];
      const T ri = b[g] - ax[c];
      r4[c] = ri;
      dot = c == 0 ? ri * (d * ri) : dot + ri * (d * ri);
    }
    local = local + dot;
  }
  if (WINDOW) fence_async();
  push_sum<T, WINDOW>(cl, me, local, red, slots[0], &bars[0], push_edges);
  stage_end(0, 0);
  T rz = slot_total(slots[0]);
  T beta = T(0);

  for (int k = 0; k < iters; ++k) {
    // 1. p = D^-1 r + beta p over the window (iteration 0: D^-1 r)
    for (int q = tid; q < wn; q += THREADS) {
      T r4[4];
      ld4(rd + 4 * q, r4);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T z = r4[3] * r4[c];
        pw[PS * q + c] = k == 0 ? z : z + beta * pw[PS * q + c];
      }
    }
    if (WINDOW)
      __syncthreads();
    else
      cl.sync();  // every slab's p is written before any CTA reads it
    // 2. Ap = A p and p.Ap over the slab
    local = T(0);
    for (int li = tid; li < rows; li += THREADS) {
      T ap[3];
      row(mv, lo + li, li,
          [&](int j, T c[3]) {
            const T* q = pw + PS * (j - wlo);
            if (PS == 3) {
              c[0] = q[0];
              c[1] = q[1];
              c[2] = q[2];
            } else {
              T v[4];
              ld4(q, v);
              c[0] = v[0];
              c[1] = v[1];
              c[2] = v[2];
            }
          },
          ap);
      const T* p3 = pw + PS * (off + li);
      T dot = T(0);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        aps[3 * li + c] = ap[c];
        dot = c == 0 ? p3[c] * ap[c] : dot + p3[c] * ap[c];
      }
      local = local + dot;
    }
    push_sum<T, WINDOW>(cl, me, local, red, slots[1], &bars[1], nothing);
    stage_end(1, k);

    // 3. alpha; x += alpha p; r -= alpha Ap; push r's edge rows; r.(D^-1 r)
    const T pAp = slot_total(slots[1]);
    const T alpha = rz / (pAp > T(0) ? pAp : T(1));
    local = T(0);
    for (int li = tid; li < rows; li += THREADS) {
      T r4[4];
      ld4(rd + 4 * (off + li), r4);
      const T* p3 = pw + PS * (off + li);
      const T d = r4[3];
      T dot = T(0);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        xs[3 * li + c] = xs[3 * li + c] + alpha * p3[c];
        const T ri = r4[c] - alpha * aps[3 * li + c];
        r4[c] = ri;
        dot = c == 0 ? ri * (d * ri) : dot + ri * (d * ri);
      }
      st4(rd + 4 * (off + li), r4);
      local = local + dot;
    }
    if (WINDOW) fence_async();
    push_sum<T, WINDOW>(cl, me, local, red, slots[0], &bars[0], push_edges);
    stage_end(0, k + 1);
    const T rz_new = slot_total(slots[0]);
    beta = rz_new / (rz > T(0) ? rz : T(1));
    rz = rz_new;
  }

  for (int li = tid; li < rows; li += THREADS) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      x_out[3 * static_cast<size_t>(lo + li) + c] = xs[3 * li + c];
  }
  cl.sync();
}

// The launch of one cluster of a solve kernel, with `smem` bytes of
// dynamic shared memory a CTA.
inline cudaLaunchConfig_t cluster_config(int smem, cudaStream_t st,
                                         cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Set a cluster kernel's attributes and ask the card whether it can
// place the cluster, once for each kernel, device and shared-memory size
// (a cluster the card cannot place is refused,
// cudaErrorInvalidClusterSize, never run smaller). The dynamic shared
// memory a kernel may take is one attribute a device, so it only grows:
// every size set up before stays launchable. A launch inside a CUDA graph
// capture finds its set-up done (prepare).
inline cudaError_t ready(const void* fn, int smem) {
  static std::set<std::tuple<const void*, int, int>> done;  // fn, dev, smem
  static std::map<std::pair<const void*, int>, int> allowed;  // the
                                                              // attribute
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(fn, dev, smem);
  std::lock_guard<std::mutex> lock(mu);
  if (done.count(key)) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1);
  int& cap = allowed[std::make_pair(fn, dev)];
  if (e == cudaSuccess && smem > cap) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess) cap = smem;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(smem, nullptr, attr);
  int clusters = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidClusterSize;
  done.insert(key);
  return cudaSuccess;
}

template <typename T, typename Row, bool WINDOW>
cudaError_t ready(int smem) {
  return ready((const void*)solve_kernel<T, Row, WINDOW>, smem);
}

// The solve's plan on the current device (plan_for_device), checked
// against the scratch given.
inline int checked_plan(int n, int H, int mat_per_row, int elem, int iters,
                        bool has_scratch, Plan* pl) {
  if (n < 1 || iters < 0 || H < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = plan_for_device(n, H, mat_per_row, elem, pl);
  if (err != 0) return err;
  if (!pl->vec_smem && !has_scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The set-up of a solve of n rows reaching H (its plan, the kernel's
// attributes, the cluster check), without a launch: what must run
// before a CUDA graph captures the solve.
template <typename T, typename Row>
int prepare(int H, int mat_per_row, int n) {
  Plan pl;
  const int err = checked_plan(n, H, mat_per_row, sizeof(T), 0, true, &pl);
  if (err != 0) return err;
  return static_cast<int>(pl.vec_smem ? ready<T, Row, true>(pl.smem_bytes)
                                      : ready<T, Row, false>(pl.smem_bytes));
}

template <typename T, typename Row, bool WINDOW>
cudaError_t launch_kernel(const Row& row, const Plan& pl, int H,
                          const T* b, const T* x0, const T* diag,
                          int diag_inv, int n, int iters, T* x, T* scratch,
                          cudaStream_t st) {
  const cudaError_t e = ready<T, Row, WINDOW>(pl.smem_bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(pl.smem_bytes, st, attr);
  return cudaLaunchKernelEx(&cfg, solve_kernel<T, Row, WINDOW>, row, b, x0,
                            diag, diag_inv, n, H, iters, x, scratch, pl.slab,
                            pl.window, pl.mat_smem);
}

// The whole solve: its plan, then one launch in the plan's layout. diag:
// the diagonal of A, or with diag_inv = 1 its inverse (D^-1 as given);
// x may be x0. scratch: the plan's elements of global scratch (nullptr
// when 0).
template <typename T, typename Row>
int solve(const Row& row, int H, int mat_per_row, const T* b, const T* x0,
          const T* diag, int diag_inv, int n, int iters, T* x, T* scratch,
          void* stream) {
  Plan pl;
  const int err = checked_plan(n, H, mat_per_row, sizeof(T), iters,
                               scratch != nullptr, &pl);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      pl.vec_smem
          ? launch_kernel<T, Row, true>(row, pl, H, b, x0, diag, diag_inv, n,
                                        iters, x, scratch, st)
          : launch_kernel<T, Row, false>(row, pl, H, b, x0, diag, diag_inv,
                                         n, iters, x, scratch, st);
  if (e != cudaSuccess) cudaGetLastError();  // returned here, not left behind
  return static_cast<int>(e);
}

}  // namespace cluster_pcg
}  // namespace admm
