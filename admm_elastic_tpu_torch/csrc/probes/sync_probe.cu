// The cost of the synchronisation the cluster solves are built from
// (cluster_pcg.cuh), alone: one cluster of 16 CTAs of 1,024 threads runs
// `iters` rounds of one mode and nothing else. A microbenchmark, not part
// of the kernel library: chip_smoke.py builds it into a library of its
// own. A round of
//   0: cluster.sync() (barrier.cluster arrive.release / wait.acquire);
//   1: __syncthreads();
//   2: warp 0 of every CTA st.async-es one value into every other CTA's
//      slot, counted on its mbarrier; every thread waits on its own
//      mbarrier for the 15 values (a stage end of the solve without its
//      sum);
//   3: mode 2 with the CTA's warp-tree sum before it and the 16 values
//      added after (a whole stage end of the solve, push_sum + the wait +
//      slot_total);
//   4: mode 3's sum, the values as plain remote stores, then
//      cluster.sync() (a stage end of the solve's SHARED layout).
// The time of a round is (time of N rounds - time of 0 rounds) / N, by
// CUDA events (chip_smoke.py, phase 3n).
//
// The grid barrier that cooperative whole-timestep kernels pay three times
// a CG iteration (the design the windows of banded_step.cu, lattice_step.cu
// and cloth_step.cu replaced), alone, on a cooperative grid of `blocks`
// CTAs of 128 threads (the caller gives such a kernel's grid: SMs x its
// resident blocks an SM). A round of
//   0: grid.sync();
//   1: a whole CG stage end without its work: every CTA's block_sum of one
//      value a thread, its partial written, grid.sync(), and every CTA
//      re-reading all partials and summing them (dia::sum_partials).
// And whether the card takes one launch that is both cooperative and
// clustered (cudaLaunchKernelEx with cudaLaunchAttributeCooperative and
// cudaLaunchAttributeClusterDimension, 128-thread CTAs): the design that
// would keep a window in one launch and run each solve on one cluster of
// it.

#include "../cluster_pcg.cuh"
#include "../dia.cuh"

namespace admm {
namespace cluster_pcg {

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) probe_kernel(int iters,
                                                           float* out) {
  // rounds alternate between two slot arrays and two mbarriers, as the
  // solve's two kinds of stage do: a round's values can then only be sent
  // once every CTA is done with the round before the last
  __shared__ float slots[2][CLUSTER];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ float red[WARPS];
  cgr::cluster_group cl = cgr::this_cluster();
  const int me = static_cast<int>(cl.block_rank());
  if (threadIdx.x == 0) {
    for (int q = 0; q < 2; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&bars[q]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();
  float acc = static_cast<float>(threadIdx.x);
  auto nothing = [] {};
  for (int k = 0; k < iters; ++k) {
    float* slot = slots[k & 1];
    uint64_t* bar = &bars[k & 1];
    if (MODE == 0) {
      cl.sync();
    } else if (MODE == 1) {
      __syncthreads();
    } else if (MODE == 2) {
      const int lane = threadIdx.x & 31;
      if (threadIdx.x < 32 && lane < CLUSTER && lane != me)
        st_async(slot + me, acc, bar, lane);
      if (threadIdx.x == 0) mbar_expect(bar, (CLUSTER - 1) * sizeof(float));
      mbar_wait(bar, (k >> 1) & 1);
    } else {
      push_sum<float, MODE == 3>(cl, me, acc, red, slot, bar, nothing);
      if (MODE == 3) {
        if (threadIdx.x == 0) mbar_expect(bar, (CLUSTER - 1) * sizeof(float));
        mbar_wait(bar, (k >> 1) & 1);
      } else {
        cl.sync();
      }
      acc = slot_total(slot);
    }
  }
  if (threadIdx.x == 0) out[me] = acc;
  cl.sync();
}

template <int MODE>
cudaError_t launch_probe(int iters, float* out, cudaStream_t st) {
  auto kern = probe_kernel<MODE>;
  const cudaError_t e = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, iters, out);
}

}  // namespace cluster_pcg

namespace grid_probe {

namespace cgr = cooperative_groups;

constexpr int THREADS = 128;

template <int MODE>
__global__ void __launch_bounds__(THREADS) probe_kernel(int iters,
                                                        float* part) {
  cgr::grid_group grid = cgr::this_grid();
  __shared__ float sh[THREADS];
  float acc = static_cast<float>(threadIdx.x);
  for (int k = 0; k < iters; ++k) {
    if (MODE == 0) {
      grid.sync();
    } else {
      // the partials ping-pong between two halves, as a cooperative CG's
      // must
      float* half = part + (k & 1) * gridDim.x;
      const float tot = block_sum(acc, sh);
      if (threadIdx.x == 0) half[blockIdx.x] = tot;
      grid.sync();
      acc = dia::sum_partials(half, gridDim.x, sh) * 1e-30f;
    }
  }
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

template <int MODE>
cudaError_t launch_probe(int iters, int blocks, float* part,
                         cudaStream_t st) {
  void* args[] = {&iters, &part};
  return cudaLaunchCooperativeKernel((const void*)probe_kernel<MODE>,
                                     dim3(blocks), dim3(THREADS), args, 0,
                                     st);
}

__global__ void __launch_bounds__(THREADS) coop_cluster_kernel(float* out) {
  cgr::grid_group grid = cgr::this_grid();
  cgr::cluster_group cl = cgr::this_cluster();
  cl.sync();
  grid.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<float>(cl.block_rank());
}

}  // namespace grid_probe
}  // namespace admm

extern "C" {

// One launch of `iters` rounds of `mode`; out: 16 floats of scratch.
// Returns a cudaError_t.
int cluster_sync_probe(int mode, int iters, float* out, void* stream) {
  using namespace admm::cluster_pcg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case 0: return static_cast<int>(launch_probe<0>(iters, out, st));
    case 1: return static_cast<int>(launch_probe<1>(iters, out, st));
    case 2: return static_cast<int>(launch_probe<2>(iters, out, st));
    case 3: return static_cast<int>(launch_probe<3>(iters, out, st));
    case 4: return static_cast<int>(launch_probe<4>(iters, out, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One cooperative launch of `iters` rounds of grid mode `mode` on
// `blocks` CTAs of 128 threads; part: 2 x blocks floats of scratch.
// Returns a cudaError_t (cudaErrorCooperativeLaunchTooLarge when the grid
// is not resident).
int grid_sync_probe(int mode, int iters, int blocks, float* part,
                    void* stream) {
  using namespace admm::grid_probe;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (iters < 0 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case 0: return static_cast<int>(launch_probe<0>(iters, blocks, part, st));
    case 1: return static_cast<int>(launch_probe<1>(iters, blocks, part, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident 128-thread CTAs an SM of grid mode `mode`'s kernel, or
// -cudaError_t.
int grid_probe_occupancy(int mode) {
  using namespace admm::grid_probe;
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm,
      mode == 0 ? (const void*)probe_kernel<0> : (const void*)probe_kernel<1>,
      THREADS, 0);
  return e == cudaSuccess ? per_sm : -static_cast<int>(e);
}

// One launch of `blocks` 128-thread CTAs, cooperative and in clusters of
// `cluster` CTAs; out: `blocks` floats. Returns the cudaError_t of the
// launch and of its completion: 0 when the card takes such a launch.
int coop_cluster_probe(int blocks, int cluster, float* out, void* stream) {
  using namespace admm::grid_probe;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)coop_cluster_kernel,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, coop_cluster_kernel, out);
  if (e == cudaSuccess) e = cudaStreamSynchronize(st);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

}  // extern "C"
