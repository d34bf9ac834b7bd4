// The element steps of nh_local.cu under each register cap tried for them,
// so that their times can be held against each other on the same inputs
// (utils/time_elements.py --designs). A microbenchmark, not part of the
// kernel library: it is built into a library of its own. Every design runs
// the same arithmetic (NeoHookean; the fused entry without emit_z) and
// must give the same bits. Design d is nh_local.cu's kernels with
// __launch_bounds__(128, d + 1): d = 0 puts no register cap below 255,
// d = 1..7 at most 65,536 / (128 (d + 1)) registers a thread, d + 1
// resident blocks an SM. Each entry returns the cudaError_t of the launch,
// or -1 for an unknown design.

#include "nh_local.cu"

namespace {

constexpr int kDesigns = 8;

// design d launches the kernels of __launch_bounds__(128, M), M = d + 1
template <typename T, int M = 1>
int probe_fused(int design, const T* x, const int* tets, const T* u,
                const T* warm, const T* cp, const T* mu, const T* lam,
                const T* k, const T* w2, T* z, T* u_out, T* warm_out,
                T* rows, int E, int iters, void* stream) {
  if constexpr (M > kDesigns) {
    return -1;
  } else {
    if (design != M - 1)
      return probe_fused<T, M + 1>(design, x, tets, u, warm, cp, mu, lam, k,
                                   w2, z, u_out, warm_out, rows, E, iters,
                                   stream);
    return admm::nh::fused_of<T, 0, false, M>(
        x, tets, u, warm, cp, mu, lam, k, w2, z, u_out, warm_out, rows, E,
        iters, static_cast<cudaStream_t>(stream));
  }
}

template <typename T, int M = 1>
int probe_step(int design, const T* dx, const T* u, const T* warm,
               const T* mu, const T* lam, const T* k, T* z, T* u_out,
               T* warm_out, int E, int iters, void* stream) {
  if constexpr (M > kDesigns) {
    return -1;
  } else {
    if (design != M - 1)
      return probe_step<T, M + 1>(design, dx, u, warm, mu, lam, k, z, u_out,
                                  warm_out, E, iters, stream);
    return admm::nh::step_of<T, 0, M>(dx, u, warm, mu, lam, k, z, u_out,
                                      warm_out, E, iters,
                                      static_cast<cudaStream_t>(stream));
  }
}

}  // namespace

extern "C" {

int nh_design_fused_f32(int design, const float* x, const int* tets,
                        const float* u, const float* warm, const float* cp,
                        const float* mu, const float* lam, const float* k,
                        const float* w2, float* z, float* u_out,
                        float* warm_out, float* rows, int E, int iters,
                        void* stream) {
  return probe_fused<float>(design, x, tets, u, warm, cp, mu, lam, k, w2, z,
                            u_out, warm_out, rows, E, iters, stream);
}

int nh_design_fused_f64(int design, const double* x, const int* tets,
                        const double* u, const double* warm,
                        const double* cp, const double* mu,
                        const double* lam, const double* k, const double* w2,
                        double* z, double* u_out, double* warm_out,
                        double* rows, int E, int iters, void* stream) {
  return probe_fused<double>(design, x, tets, u, warm, cp, mu, lam, k, w2, z,
                             u_out, warm_out, rows, E, iters, stream);
}

int nh_design_step_f32(int design, const float* dx, const float* u,
                       const float* warm, const float* mu, const float* lam,
                       const float* k, float* z, float* u_out,
                       float* warm_out, int E, int iters, void* stream) {
  return probe_step<float>(design, dx, u, warm, mu, lam, k, z, u_out,
                           warm_out, E, iters, stream);
}

int nh_design_step_f64(int design, const double* dx, const double* u,
                       const double* warm, const double* mu,
                       const double* lam, const double* k, double* z,
                       double* u_out, double* warm_out, int E, int iters,
                       void* stream) {
  return probe_step<double>(design, dx, u, warm, mu, lam, k, z, u_out,
                            warm_out, E, iters, stream);
}

}  // extern "C"
