// The element steps of tet_local.cu under each schedule tried for them, so
// that their times can be held against each other on the same inputs
// (utils/time_elements.py --force arap --designs). A microbenchmark, not
// part of the kernel library: it is built into a library of its own.
// Every design runs the same arithmetic (the fused entry without emit_z)
// and must give the same bits. Design d is tet_local.cu's kernels with
// __launch_bounds__(128, d + 1): d = 0 puts no register cap below 255,
// d = 1..7 at most 65,536 / (128 (d + 1)) registers a thread, d + 1
// resident blocks an SM. Each entry returns the cudaError_t of the launch,
// or -1 for an unknown design.

#include "tet_local.cu"

namespace {

constexpr int kDesigns = 8;

// design d launches the kernels of __launch_bounds__(128, M), M = d + 1
template <typename T, int M = 1>
int probe_fused(int design, const T* x, const int* tets, const T* u,
                const T* cp, const T* w2, const T* k, T* z, T* u_out,
                T* rows, int E, void* stream) {
  if constexpr (M > kDesigns) {
    return -1;
  } else {
    if (design != M - 1)
      return probe_fused<T, M + 1>(design, x, tets, u, cp, w2, k, z, u_out,
                                   rows, E, stream);
    return admm::arap::fused_of<T, false, M>(
        x, tets, u, cp, w2, k, z, u_out, rows, E,
        static_cast<cudaStream_t>(stream));
  }
}

template <typename T, int M = 1>
int probe_step(int design, const T* dx, const T* u, const T* w2, const T* k,
               T* z, T* u_out, int E, void* stream) {
  if constexpr (M > kDesigns) {
    return -1;
  } else {
    if (design != M - 1)
      return probe_step<T, M + 1>(design, dx, u, w2, k, z, u_out, E, stream);
    return admm::arap::step_of<T, M>(dx, u, w2, k, z, u_out, E,
                                     static_cast<cudaStream_t>(stream));
  }
}

}  // namespace

extern "C" {

int arap_design_fused_f32(int design, const float* x, const int* tets,
                          const float* u, const float* cp, const float* w2,
                          const float* k, float* z, float* u_out, float* rows,
                          int E, void* stream) {
  return probe_fused<float>(design, x, tets, u, cp, w2, k, z, u_out, rows, E,
                            stream);
}

int arap_design_fused_f64(int design, const double* x, const int* tets,
                          const double* u, const double* cp, const double* w2,
                          const double* k, double* z, double* u_out,
                          double* rows, int E, void* stream) {
  return probe_fused<double>(design, x, tets, u, cp, w2, k, z, u_out, rows,
                             E, stream);
}

int arap_design_step_f32(int design, const float* dx, const float* u,
                         const float* w2, const float* k, float* z,
                         float* u_out, int E, void* stream) {
  return probe_step<float>(design, dx, u, w2, k, z, u_out, E, stream);
}

int arap_design_step_f64(int design, const double* dx, const double* u,
                         const double* w2, const double* k, double* z,
                         double* u_out, int E, void* stream) {
  return probe_step<double>(design, dx, u, w2, k, z, u_out, E, stream);
}

}  // extern "C"
