// One fused Jacobi-PCG vector update, for Hopper.
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
// What bounds it on this card: launches. At delaunay100k (n = 16,280) it
// moves ~1.4 MB in f32 (0.4 us of HBM time, and L2-resident anyway) and
// does ~0.2 Mflop.
//
// Design: the two dependent reductions (pAp, then rz') split the update
// into the chain of pcg_chain.cuh: dot (partials of p.Ap), update (alpha,
// x', r', partials of rz'), direction (beta, p', and rz' written by block
// 0). Three plain launches, fixed-order partial sums, no atomics.

#include "pcg_chain.cuh"

namespace admm {
namespace step {

template <typename T>
int update(const T* x, const T* r, const T* p, const T* rz, const T* Ap,
           const T* invd, int n, T* x_out, T* r_out, T* p_out, T* rz_out,
           T* partials, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  using chain::THREADS;
  const int nb = chain::blocks_for(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  T* pap = partials;
  T* rz_new = partials + nb;
  cudaError_t err;
  chain::dot_kernel<T><<<nb, THREADS, 0, st>>>(p, Ap, n, pap);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chain::update_kernel<T><<<nb, THREADS, 0, st>>>(
      p, Ap, invd, pap, nb, rz, 1, n, x, r, x_out, r_out, rz_new);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chain::direction_kernel<T><<<nb, THREADS, 0, st>>>(
      r_out, invd, rz, 1, rz_new, nb, n, p, p_out, rz_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace step
}  // namespace admm

extern "C" {

// x, r, p, Ap: (n,3); invd: (n,); rz, rz_out: one value; partials:
// cg_partials(n) scratch. Outputs must not alias inputs. Returns the
// first nonzero cudaError_t of the launches, or 0.
int cg_update_f32(const float* x, const float* r, const float* p,
                  const float* rz, const float* Ap, const float* invd, int n,
                  float* x_out, float* r_out, float* p_out, float* rz_out,
                  float* partials, void* stream) {
  return admm::step::update<float>(x, r, p, rz, Ap, invd, n, x_out, r_out,
                                   p_out, rz_out, partials, stream);
}

int cg_update_f64(const double* x, const double* r, const double* p,
                  const double* rz, const double* Ap, const double* invd,
                  int n, double* x_out, double* r_out, double* p_out,
                  double* rz_out, double* partials, void* stream) {
  return admm::step::update<double>(x, r, p, rz, Ap, invd, n, x_out, r_out,
                                    p_out, rz_out, partials, stream);
}

// Length of cg_update's partials scratch for n rows: the p.Ap and the
// new rz partials, one of each per block.
int cg_partials(int n) { return 2 * admm::chain::blocks_for(n); }

}  // extern "C"
